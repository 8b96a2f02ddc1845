"""The port's quality scripts, counterparts of the JAX package's
``scripts/flagship_quality_eval.py``, ``scripts/full_domain_quality_eval.py``
and ``scripts/edm_quality_study.py``: the same arguments, defaults, output
files and JSON keys, each run on the port's entry points and, on the card,
each sampler call as a replay of its CUDA graph. Run one as
``python -m sbgm_danra_tpu_torch.scripts.<name> [--device cpu]``.
"""
