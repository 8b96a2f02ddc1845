"""Ensembles on one card (counterpart of ``sbgm_danra_tpu.parallel``, cut to
``ensemble.py``; the mesh routes wait for ROADMAP Queue 1 item 7)."""
