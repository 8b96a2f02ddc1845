"""Analysis pipelines (counterpart of ``sbgm_danra_tpu.pipelines``, cut to the
spectrum estimator)."""
