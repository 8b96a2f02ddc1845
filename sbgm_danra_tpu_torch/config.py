"""The port's reader of the repo's YAML run configs.

A copy of the parts of ``sbgm_danra_tpu/config.py`` that the port reads: the
same section and field names, defaults, ``${env:VAR}`` interpolation, dot-key
overrides and type coercion, and ``get_model_string`` from
``sbgm_danra_tpu/utils/naming.py``. Only the fields that ``serve.py`` and
``models/unet.py`` read are declared; every other section and key of a config
is skipped, since the JAX package's reader is the one that checks them.

PyYAML is imported inside ``load_config`` and ``parse_override`` only, so that
the serving path imports it only when it reads a file.
"""

from __future__ import annotations

import dataclasses
import os
import re
import typing
from dataclasses import dataclass, field
from typing import Any, Dict, Mapping, Optional, Tuple

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
class HighresConfig:
    model: str = "DANRA"
    variable: str = "temp"
    data_size: Tuple[int, int] = (128, 128)


@dataclass
class LowresConfig:
    model: str = "ERA5"
    condition_variables: Tuple[str, ...] = ("temp",)
    resize_factor: int = 1


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


@dataclass
class GeographicConfig:
    sample_w_geo: bool = True
    geo_variables: Tuple[str, ...] = ("lsm", "topo")


@dataclass
class SeasonalConfig:
    sample_w_cond_season: bool = True
    n_seasons: int = 4


@dataclass
class StationaryConditionsConfig:
    geographic_conditions: GeographicConfig = field(default_factory=GeographicConfig)
    seasonal_conditions: SeasonalConfig = field(default_factory=SeasonalConfig)


@dataclass
class TrainingConfig:
    loss_type: str = "sdfweighted"


@dataclass
class CFGuidanceConfig:
    enabled: bool = True
    guidance_scale: float = 3.0
    guidance_scale_max: Optional[float] = None


@dataclass
class EvaluationConfig:
    n_steps: int = 1000
    spread_calibration: Optional[float] = None


@dataclass
class Config:
    experiment: ExperimentConfig = field(default_factory=ExperimentConfig)
    highres: HighresConfig = field(default_factory=HighresConfig)
    lowres: LowresConfig = field(default_factory=LowresConfig)
    sampler: SamplerConfig = field(default_factory=SamplerConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    stationary_conditions: StationaryConditionsConfig = field(
        default_factory=StationaryConditionsConfig
    )
    training: TrainingConfig = field(default_factory=TrainingConfig)
    classifier_free_guidance: CFGuidanceConfig = field(default_factory=CFGuidanceConfig)
    evaluation: EvaluationConfig = field(default_factory=EvaluationConfig)

    def in_channels(self) -> int:
        """Conditioning channels: n_lr + 2 per geo variable."""
        n_lr = len(self.lowres.condition_variables or ())
        geo = self.stationary_conditions.geographic_conditions
        n_geo = 2 * len(geo.geo_variables) if geo.sample_w_geo else 0
        return n_lr + n_geo

    def num_classes(self) -> Optional[int]:
        sc = self.stationary_conditions.seasonal_conditions
        return sc.n_seasons if sc.sample_w_cond_season else None


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
