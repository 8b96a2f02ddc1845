"""Train state: the module (parameters and BatchNorm statistics), the optimizer
and a working EMA copy (counterpart of ``sbgm_danra_tpu/training/state.py``).

JAX keeps one immutable pytree and the compiled step returns a new one; here
the state is updated in place: the module's parameters and BatchNorm buffers,
the optimizer's state, the EMA tensors and the step counter (a 0-d int64
tensor beside them, so that a step, captured or not, counts on the device;
``step`` reads it). The EMA is ``d e + (1 - d) p`` after every optimizer
step (``update_ema``). The learning rate lives in the optimizer's parameter
groups, where a host-side scheduler writes it between epochs
(``with_learning_rate``), as the JAX state's injected hyperparameter.

``make_capturable`` readies the state for a train step captured into a CUDA
graph: Adam and AdamW take ``capturable=True`` (their step counts on the
card) and the learning rate becomes a 0-d tensor on the card, which
``with_learning_rate`` fills in place, so that a graph reads each epoch's
rate. SGD's step reads a tensor rate on the host, so its rate stays a float
and ``lr_key`` gives it to the graph's key (a new rate, a new capture).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from sbgm_danra_tpu_torch.models.layers import BatchNorm

_EPS = 1e-8  # optax's adam eps


def make_optimizer(training_cfg, params) -> torch.optim.Optimizer:
    """The JAX factory's three optimizers (``state.py:91-116``):

    - ``adam``: L2 added to the gradients before Adam
      (``optax.add_decayed_weights`` then ``optax.adam``) is
      ``torch.optim.Adam(weight_decay=...)``;
    - ``adamw``: decoupled decay (``optax.adamw``) is ``torch.optim.AdamW``;
    - ``sgd``: L2 added, then SGD with momentum (``optax.sgd(momentum=...)``,
      whose trace starts from zero as torch's buffer starts from the first
      gradient).
    Betas 0.9 / 0.999 and eps 1e-8, as optax's defaults.
    """
    t = training_cfg
    params = list(params)
    if t.optimizer == "adam":
        return torch.optim.Adam(params, lr=t.learning_rate, eps=_EPS, weight_decay=t.weight_decay)
    if t.optimizer == "adamw":
        return torch.optim.AdamW(params, lr=t.learning_rate, eps=_EPS,
                                 weight_decay=t.weight_decay)
    if t.optimizer == "sgd":
        return torch.optim.SGD(params, lr=t.learning_rate, momentum=t.momentum,
                               weight_decay=t.weight_decay)
    raise ValueError(f"Unknown optimizer: {t.optimizer}")


@torch.no_grad()
def xavier_init_convs(model: nn.Module, generator: Optional[torch.Generator] = None) -> nn.Module:
    """Conv kernels (every rank-4 weight) Xavier-uniform, their biases 0.01.

    The JAX function draws ``xavier_uniform`` on HWIO kernels with fan_in =
    kh kw Cin and fan_out = kh kw Cout; ``nn.init.xavier_uniform_`` on the
    port's OIHW (and transposed-conv IOHW) weights takes the same fans, so the
    bound sqrt(6 / (fan_in + fan_out)) is the same. Other parameters keep
    their values.
    """
    for module in model.modules():
        if isinstance(module, (nn.Conv2d, nn.ConvTranspose2d)) and module.weight.dim() == 4:
            nn.init.xavier_uniform_(module.weight, generator=generator)
            if module.bias is not None:
                module.bias.fill_(0.01)
    return model


def batch_norms(model: nn.Module):
    return [m for m in model.modules() if isinstance(m, BatchNorm)]


class TrainState:
    """The module, its optimizer, the EMA copy of its parameters and the step."""

    def __init__(self, model: nn.Module, optimizer: torch.optim.Optimizer,
                 ema_decay: float = 0.9999, use_ema: bool = True):
        self.model = model
        self.optimizer = optimizer
        self.ema_decay = ema_decay
        self.use_ema = use_ema
        self.step_count = torch.zeros((), dtype=torch.int64)
        self.ema_params: Dict[str, torch.Tensor] = {
            name: p.detach().clone() for name, p in model.named_parameters()}

    @property
    def step(self) -> int:
        return int(self.step_count)

    @step.setter
    def step(self, value: int) -> None:
        self.step_count.fill_(int(value))

    def to(self, device) -> "TrainState":
        """The EMA copy and the step counter on ``device`` (the module and the
        optimizer's state move with the module); returns self."""
        self.ema_params = {k: v.to(device) for k, v in self.ema_params.items()}
        self.step_count = self.step_count.to(device)
        return self

    @property
    def learning_rate(self) -> float:
        return float(self.optimizer.param_groups[0]["lr"])

    def with_learning_rate(self, lr: float) -> "TrainState":
        """Write ``lr`` into every parameter group (in place: a tensor rate is
        filled); returns self."""
        for group in self.optimizer.param_groups:
            if isinstance(group["lr"], torch.Tensor):
                group["lr"].fill_(float(lr))
            else:
                group["lr"] = float(lr)
        return self

    def make_capturable(self) -> "TrainState":
        """Ready the optimizer for a captured step on the parameters' device
        (see the module's notes); idempotent, and run again after a restore."""
        if not isinstance(self.optimizer, (torch.optim.Adam, torch.optim.AdamW)):
            return self
        for group in self.optimizer.param_groups:
            dev = group["params"][0].device
            group["capturable"] = True
            lr = group["lr"]
            if not (isinstance(lr, torch.Tensor) and lr.device == dev):
                group["lr"] = torch.tensor(float(lr), dtype=torch.float32, device=dev)
            for p in group["params"]:
                state = self.optimizer.state.get(p, {})
                if "step" in state:
                    state["step"] = state["step"].to(device=dev, dtype=torch.float32)
        return self

    def make_eager(self) -> "TrainState":
        """The optimizer as an eager step runs it, a float rate and
        ``capturable`` off: ``make_capturable`` undone, e.g. after restoring
        a checkpoint written on the card into a trainer on the CPU."""
        for group in self.optimizer.param_groups:
            if isinstance(group["lr"], torch.Tensor):
                group["lr"] = float(group["lr"])
            if group.get("capturable"):
                group["capturable"] = False
        return self

    def lr_key(self):
        """What a captured step bakes in of the learning rate: None when the
        rate is a tensor the graph reads, else the float."""
        lr = self.optimizer.param_groups[0]["lr"]
        return None if isinstance(lr, torch.Tensor) else float(lr)

    def update_tensors(self) -> list:
        """Every tensor a train step writes: parameters, optimizer state, EMA,
        BatchNorm statistics, the step counter."""
        out = list(self.model.parameters())
        for p in self.model.parameters():
            out += [v for v in self.optimizer.state.get(p, {}).values()
                    if isinstance(v, torch.Tensor)]
        out += list(self.ema_params.values())
        out += [b for name, b in self.model.named_buffers()
                if name.endswith(("running_mean", "running_var"))]
        out.append(self.step_count)
        return out

    def signature(self) -> tuple:
        """Where the state lives: the address of every tensor a step reads or
        writes (``update_tensors`` and a tensor learning rate) and a float
        rate. A captured step is stale once this changes (a restore replaces
        the optimizer's state, a move replaces everything)."""
        lrs = tuple(g["lr"].data_ptr() if isinstance(g["lr"], torch.Tensor) else g["lr"]
                    for g in self.optimizer.param_groups)
        return tuple(t.data_ptr() for t in self.update_tensors()) + lrs

    @torch.no_grad()
    def update_ema(self) -> None:
        """ema = d ema + (1 - d) params, after an optimizer step."""
        if not self.use_ema:
            return
        d = self.ema_decay
        ema = list(self.ema_params.values())
        params = [p.detach() for p in self.model.parameters()]
        torch._foreach_mul_(ema, d)
        torch._foreach_add_(ema, torch._foreach_mul(params, 1.0 - d))

    def batch_stats(self) -> Dict[str, torch.Tensor]:
        """The BatchNorm running statistics, by state_dict key."""
        return {k: v for k, v in self.model.state_dict().items()
                if k.endswith(("running_mean", "running_var"))}


def create_train_state(cfg, model: nn.Module, generator: Optional[torch.Generator] = None
                       ) -> TrainState:
    """Xavier re-init (``training.weight_init``), optimizer and EMA copy for ``model``."""
    t = cfg.training
    if t.weight_init:
        xavier_init_convs(model, generator)
    return TrainState(model, make_optimizer(t, model.parameters()), t.ema_decay, t.with_ema)
