"""Training engine of the torch port (counterpart of ``sbgm_danra_tpu/training``)."""
