"""Data preparation and analysis pipelines (counterpart of
``sbgm_danra_tpu.pipelines``, less the ERA5 download): splits, global
statistics, store comparison and spectra, correlations, preprocessing and the
data-analysis figures. numpy on the host, as in JAX."""
