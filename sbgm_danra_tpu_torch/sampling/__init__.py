"""Samplers and classifier-free guidance (counterpart of ``sbgm_danra_tpu.sampling``)."""
