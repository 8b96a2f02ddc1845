"""Data-parallel training, member-sharded ensembles, ring attention and
tensor-parallel hooks on ``torch.distributed`` (counterpart of
``sbgm_danra_tpu.parallel``): ``mesh.py`` (process-group meshes),
``collectives.py`` (each collective's route by backend), ``train.py``,
``ensemble.py``, ``windowed_dp.py``, ``ring_attention.py``, ``tp.py``, and
``launch.py`` (ranks as child processes, for tests and the card check).
"""

from sbgm_danra_tpu_torch.parallel.mesh import make_mesh, replicate, shard_batch

__all__ = ["make_mesh", "replicate", "shard_batch"]
