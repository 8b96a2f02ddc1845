"""Evaluation-time generation (counterpart of ``sbgm_danra_tpu.evaluate``)."""
