"""The port's reader of the repo's YAML run configs.

A copy of the parts of ``sbgm_danra_tpu/config.py`` that the port reads: the
same section and field names, defaults, ``${env:VAR}`` interpolation, dot-key
overrides and type coercion, and ``get_model_string`` from
``sbgm_danra_tpu/utils/naming.py``. Only the fields that ``serve.py``,
``models/unet.py``, ``transforms.py`` (the statistics files behind the
transforms), ``data/``, ``training/``, ``evaluate/``, ``pipelines/`` and ``cli/`` read are
declared, under the JAX reader's names and defaults; every other section and key of a config
is skipped, since the JAX package's reader is the one that checks them. The port adds
``model.arch`` and the SongUNet keys of its own CorrDiff (``models/songunet.py``), which the
JAX package does not have.

PyYAML is imported inside ``load_config``, ``parse_override`` and ``Config.dump`` only, so
that the serving path imports it only when it reads a file; without it ``dump`` logs a
skip and writes nothing.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import re
import typing
from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional, Tuple

logger = logging.getLogger(__name__)

_ENV_RE = re.compile(r"\$\{env:([A-Za-z_][A-Za-z0-9_]*)\}")


def resolve_env(value: Any) -> Any:
    """Recursively substitute ``${env:VAR}`` in strings."""
    if isinstance(value, str):

        def _sub(m: re.Match) -> str:
            var = m.group(1)
            if var not in os.environ:
                raise KeyError(f"Config references undefined environment variable: {var}")
            return os.environ[var]

        return _ENV_RE.sub(_sub, value)
    if isinstance(value, Mapping):
        return {k: resolve_env(v) for k, v in value.items()}
    if isinstance(value, list):
        return [resolve_env(v) for v in value]
    return value


def deep_update(base: Dict[str, Any], updates: Mapping[str, Any]) -> Dict[str, Any]:
    """Apply dot-keyed updates in place."""
    for dotted, val in updates.items():
        node = base
        keys = dotted.split(".")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = val
    return base


@dataclass
class ExperimentConfig:
    config_name: str = "sbgm_run"


@dataclass
class PathsConfig:
    data_dir: str = "./data"
    checkpoint_dir: str = "./checkpoints"
    sample_dir: str = "./samples"
    lsm_path: str = ""
    topo_path: str = ""
    stats_load_dir: str = "./stats"


@dataclass
class HighresConfig:
    model: str = "DANRA"
    variable: str = "temp"
    data_size: Tuple[int, int] = (128, 128)
    scaling_method: str = "zscore"
    full_domain_dims: Tuple[int, int] = (589, 789)
    cutout_domains: Optional[Tuple[int, int, int, int]] = (170, 350, 340, 520)
    buffer_frac: float = 0.5
    # inline scaling parameters; the statistics files win where they exist
    scaling_params: Optional[Dict[str, float]] = None


@dataclass
class LowresConfig:
    model: str = "ERA5"
    condition_variables: Tuple[str, ...] = ("temp",)
    scaling_methods: Tuple[str, ...] = ("zscore",)
    data_size: Optional[Tuple[int, int]] = None
    full_domain_dims: Tuple[int, int] = (589, 789)
    cutout_domains: Optional[Tuple[int, int, int, int]] = None
    resize_factor: int = 1
    buffer_frac: float = 0.5
    scaling_params: Optional[List[Dict[str, float]]] = None


@dataclass
class SamplerConfig:
    sampler_type: str = "pc_sampler"
    n_timesteps: int = 1000
    time_embedding: int = 256
    last_fmap_channels: int = 512
    num_heads: int = 4
    block_layers: Tuple[int, ...] = (2, 2, 2, 2)
    snr: float = 0.16
    t_eps: float = 1e-3
    edm_rho: float = 7.0
    s_churn: float = 0.0


@dataclass
class ModelConfig:
    use_resize_conv: bool = True
    decoder_norm: str = "group"
    decoder_gn_groups: int = 8
    decoder_activation: str = "silu"
    compute_dtype: str = "float32"
    attention_backend: str = "xla"
    # "score_unet" (the JAX package's network) or "corrdiff" (the port's
    # models/songunet.py, with the SongUNet keys below and sde.EDMSDE(sigma_max))
    arch: str = "score_unet"
    img_resolution: int = 448
    model_channels: int = 128
    channel_mult: Tuple[int, ...] = (1, 2, 2, 2, 2)
    channel_mult_emb: int = 4
    channel_mult_noise: int = 1
    num_blocks: int = 4
    attn_resolutions: Tuple[int, ...] = (28,)
    dropout: float = 0.13
    sigma_data: float = 0.5
    sigma_max: float = 800.0


@dataclass
class DataHandlingConfig:
    cache_size: int = 0
    num_workers: int = 4
    n_gen_samples: int = 3
    prefetch_depth: int = 2  # batches copied to the card ahead of the step
    # the whole split resident on the card, batches put together there
    # (data/device_data.py); needs resize_factor 1 and LR on the HR grid
    device_dataset: bool = False
    # > 0 enables the rotating-window variant (data/windowed_data.py) for the
    # TRAIN split: archives larger than the card keep only window_days days
    # resident (two preallocated card slots: active + staged), refilled by a
    # background host thread. The valid split stays fully resident.
    device_window_days: int = 0
    # Batches trained per window: 0 = swap as soon as the next window is
    # staged (throughput mode); k > 0 = exactly k (reproducible mode).
    device_window_steps: int = 0
    # Staging dtype for window buffers ("float32" | "bfloat16"). bfloat16
    # halves the host-to-card copy and the resident bytes per window; its
    # rounding is ~0.4% of a z-scored field's std, the precision the forward
    # pass already uses when model.compute_dtype is bfloat16.
    device_window_dtype: str = "bfloat16"
    # Window composition: "consecutive" (contiguous archive days: sequential
    # host reads, but seasonally correlated windows) or "strided" (each
    # window spans the whole archive with stride n_windows: the per-step
    # distribution approximates global i.i.d. sampling; the same bytes read
    # per window with daily zarr groups).
    device_window_layout: str = "consecutive"


@dataclass
class GeographicConfig:
    sample_w_geo: bool = True
    sample_w_sdf: bool = True
    geo_variables: Tuple[str, ...] = ("lsm", "topo")
    norm_min: float = 0.0
    norm_max: float = 1.0


@dataclass
class SeasonalConfig:
    sample_w_cond_season: bool = True
    n_seasons: int = 4


@dataclass
class StationaryConditionsConfig:
    geographic_conditions: GeographicConfig = field(default_factory=GeographicConfig)
    seasonal_conditions: SeasonalConfig = field(default_factory=SeasonalConfig)


@dataclass
class TransformsConfig:
    scaling: bool = True
    sample_w_cutouts: bool = True


@dataclass
class VisualizationConfig:
    """``preview_every``: preview sampling every N epochs (0: off). Figures
    need matplotlib, which the port imports only inside a figure function
    (``utils/plotting.py``); where it is missing a figure is skipped with a
    log line."""

    save_figs: bool = True
    plot_initial_sample: bool = False
    plot_losses: bool = True
    preview_every: int = 0


@dataclass
class LRSchedulerParams:
    factor: float = 0.5
    patience: int = 5
    threshold: float = 0.01
    min_lr: float = 1e-6
    step_size: int = 10
    gamma: float = 0.1
    t_max: int = 100
    eta_min: float = 1e-6


@dataclass
class EarlyStoppingParams:
    patience: int = 50
    min_delta: float = 1e-4


@dataclass
class TrainingConfig:
    """The fields of the JAX reader's training section, all of which the port's
    trainer and serving engine act on. ``profile_dir``: a ``torch.profiler``
    Chrome trace of the first training epoch under that directory ('' = off;
    ``utils/profiling.trace``).
    ``async_checkpointing``: checkpoint writes leave the training loop (a
    snapshot on the device, then the copy to the host and ``torch.save`` on a
    worker thread; ``training/checkpointing.py``).
    ``checkpoint_min_interval_epochs``: best-validation checkpoint writes at
    most every N epochs; an improvement inside the window is held as a
    snapshot on the device and written at the next eligible epoch or at the
    loop's end (``TrainingPipeline.train``). ``fused_steps`` runs K steps per
    dispatch, as JAX runs it (``training/fused.py``). ``monitor_extremes``
    runs the extreme-precipitation sentinel on the back-transformed HR batch every 50
    steps (``utils/sentinels.py``; skipped under ``fused_steps``), with
    ``extreme_cap`` in mm/day."""

    seed: int = 42
    batch_size: int = 16
    learning_rate: float = 5e-4
    lr_scheduler: str = "ReduceLROnPlateau"  # | StepLR | CosineAnnealing | none
    lr_scheduler_params: LRSchedulerParams = field(default_factory=LRSchedulerParams)
    weight_init: bool = True
    with_ema: bool = True
    load_ema: bool = False
    ema_decay: float = 0.9999
    weight_decay: float = 1e-6
    epochs: int = 100
    steps_per_epoch: Optional[int] = None
    loss_type: str = "sdfweighted"
    sdf_weighted_loss: bool = True
    optimizer: str = "adam"  # adam | adamw | sgd
    momentum: float = 0.9
    early_stopping: bool = True
    early_stopping_params: EarlyStoppingParams = field(default_factory=EarlyStoppingParams)
    detect_anomaly: bool = False
    remat: bool = False
    skip_nonfinite_updates: bool = False
    fused_steps: int = 0
    checkpoint_min_interval_epochs: int = 1
    async_checkpointing: bool = False
    load_checkpoint: bool = False
    verbose: bool = True
    monitor_extremes: bool = True
    extreme_cap: float = 300.0
    profile_dir: str = ""


@dataclass
class CFGuidanceConfig:
    enabled: bool = True
    drop_prob: float = 0.1
    guidance_scale: float = 3.0
    guidance_scale_max: Optional[float] = None


@dataclass
class EvaluationConfig:
    n_gen_samples: int = 1
    n_steps: int = 1000
    batch_size: int = 1
    seed: int = 42
    gen_type: Tuple[str, ...] = ("multiple",)  # multiple | single | repeated | full_domain
    n_full_domain_samples: int = 1  # batch size for gen_type full_domain
    n_repeats: int = 8
    save_samples: bool = True
    save_figs: bool = True
    fig_name: str = "generated_samples"
    eval_stat_methods: Tuple[str, ...] = ("pixel_stats", "spatial_stats")
    mask_ocean: bool = False
    # ensemble inflation factor applied to repeated-mode members in normalised
    # space before the back-transform (evaluate/calibration.py); None: raw members
    spread_calibration: Optional[float] = None


@dataclass
class SplitsConfig:
    """Split creation (``pipelines/splits.py``): year ranges, inclusive, for
    "Time"; ``fractions`` (default 0.7 / 0.15 / 0.15) and ``seed`` for "Random"."""

    method: str = "Time"  # Time | Random
    train_years: Tuple[int, int] = (1990, 2015)
    valid_years: Tuple[int, int] = (2016, 2018)
    test_years: Tuple[int, int] = (2019, 2022)
    fractions: Optional[Dict[str, float]] = None
    seed: int = 0


@dataclass
class ParallelConfig:
    mesh_shape: Optional[Dict[str, int]] = None


@dataclass
class Config:
    experiment: ExperimentConfig = field(default_factory=ExperimentConfig)
    paths: PathsConfig = field(default_factory=PathsConfig)
    highres: HighresConfig = field(default_factory=HighresConfig)
    lowres: LowresConfig = field(default_factory=LowresConfig)
    sampler: SamplerConfig = field(default_factory=SamplerConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    data_handling: DataHandlingConfig = field(default_factory=DataHandlingConfig)
    transforms: TransformsConfig = field(default_factory=TransformsConfig)
    stationary_conditions: StationaryConditionsConfig = field(
        default_factory=StationaryConditionsConfig
    )
    training: TrainingConfig = field(default_factory=TrainingConfig)
    classifier_free_guidance: CFGuidanceConfig = field(default_factory=CFGuidanceConfig)
    evaluation: EvaluationConfig = field(default_factory=EvaluationConfig)
    visualization: VisualizationConfig = field(default_factory=VisualizationConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
    splits: SplitsConfig = field(default_factory=SplitsConfig)

    def in_channels(self) -> int:
        """Conditioning channels: n_lr + 2 per geo variable."""
        n_lr = len(self.lowres.condition_variables or ())
        geo = self.stationary_conditions.geographic_conditions
        n_geo = 2 * len(geo.geo_variables) if geo.sample_w_geo else 0
        return n_lr + n_geo

    def num_classes(self) -> Optional[int]:
        sc = self.stationary_conditions.seasonal_conditions
        return sc.n_seasons if sc.sample_w_cond_season else None

    def dump(self, path: str) -> Optional[str]:
        """Write the frozen resolved config (the sections the port declares)
        as YAML; returns the path, or None with a log line where PyYAML is
        missing."""
        try:
            import yaml
        except ImportError:
            logger.info("frozen config %s skipped: PyYAML missing", os.path.basename(path))
            return None
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            yaml.safe_dump(_jsonify(dataclasses.asdict(self)), f, sort_keys=False)
        return path


def _jsonify(obj: Any) -> Any:
    if isinstance(obj, Mapping):
        return {k: _jsonify(v) for k, v in obj.items()}
    if isinstance(obj, (tuple, list)):
        return [_jsonify(v) for v in obj]
    # numpy scalars leak in from samplers and metrics; YAML needs Python natives
    if hasattr(obj, "item") and not isinstance(obj, (str, bytes)):
        try:
            return obj.item()
        except Exception:
            return obj
    return obj


def _coerce(value: Any, typ: Any) -> Any:
    origin = getattr(typ, "__origin__", None)
    if dataclasses.is_dataclass(typ) and isinstance(value, Mapping):
        return _from_mapping(typ, value)
    if value is None:
        return None
    if origin is tuple:
        args = typ.__args__
        if len(args) == 2 and args[1] is Ellipsis:
            return tuple(_coerce(v, args[0]) for v in value)
        return tuple(_coerce(v, t) for v, t in zip(value, args))
    if typ is float and isinstance(value, (int, str)):
        return float(value)
    if typ is int and isinstance(value, (float, str)):
        return int(value)
    if origin is typing.Union:  # Optional[X]
        for t in typ.__args__:
            if t is type(None):
                continue
            try:
                return _coerce(value, t)
            except (TypeError, ValueError):
                continue
    return value


def _from_mapping(cls, data: Mapping[str, Any]):
    """Build ``cls`` from the keys it declares; the rest of the section is skipped."""
    hints = typing.get_type_hints(cls)
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: _coerce(v, hints[k]) for k, v in data.items() if k in names})


def from_dict(data: Mapping[str, Any]) -> Config:
    """A nested dict of config sections -> typed Config."""
    return _from_mapping(Config, data)


def load_config(path: str, overrides: Optional[Mapping[str, Any]] = None) -> Config:
    """Load YAML -> resolve ${env:} -> apply dot-key overrides -> typed Config."""
    import yaml

    with open(path, "r") as f:
        raw = yaml.safe_load(f) or {}
    raw = resolve_env(raw)
    if overrides:
        deep_update(raw, overrides)
    return _from_mapping(Config, raw)


def parse_override(s: str) -> Tuple[str, Any]:
    """Parse a 'a.b.c=value' CLI override; values parse as YAML scalars."""
    import yaml

    if "=" not in s:
        raise ValueError(f"Override must look like key.path=value, got: {s}")
    key, _, val = s.partition("=")
    return key.strip(), yaml.safe_load(val)


def get_model_string(cfg: Config) -> str:
    """Canonical run/checkpoint name, as ``sbgm_danra_tpu/utils/naming.py`` makes it."""
    hr_size = tuple(cfg.highres.data_size or (128, 128))
    rf = cfg.lowres.resize_factor
    if rf > 1:
        hr_size = (hr_size[0] // rf, hr_size[1] // rf)
    lr_vars = "_".join(cfg.lowres.condition_variables or ())
    return (
        f"{cfg.experiment.config_name}__"
        f"HR_{cfg.highres.variable}_{cfg.highres.model}__"
        f"SIZE_{hr_size[0]}x{hr_size[1]}__"
        f"LR_{lr_vars}_{cfg.lowres.model}__"
        f"LOSS_{cfg.training.loss_type}__"
        f"HEADS_{cfg.sampler.num_heads}__"
        f"TIMESTEPS_{cfg.sampler.n_timesteps}"
    )
