"""Inference service: conditional generation behind a small HTTP API
(counterpart of ``sbgm_danra_tpu/serve.py:55-367``).

- ``InferenceEngine``: holds the model on one device and runs the configured
  sampler at a fixed member capacity;
- ``_Batcher``: a dispatcher thread greedily packs every queued request's
  member rows into the next fixed-capacity dispatch (no batching window);
- ``make_handler``: a stdlib ``http.server`` JSON API,
    GET  /healthz   -> {"status": "ok", "model", "platform", "max_members", ...}
    POST /generate  -> body {"conditions": {...}, "n_members": N, "seed": S,
                             "spread_calibration": A}; returns the fields.

Each member row draws its noise from its own ``torch.Generator``, seeded from
(request seed, member index), and the Langevin step of ``pc_sampler`` is taken
per member, so a request's rows are computed the same way alone or co-batched
(the JAX engine vmaps a batch-of-one sampler for the same property). The
dispatch shape never changes, and on CUDA the engine sets
``cudnn.deterministic=True`` and ``cudnn.benchmark=False``. On the card a
dispatch is one replay of the sampler's CUDA graph at the engine's member
capacity (``sampling/graphs.py``): each row's noise is drawn from its own
generator into the graph's draws buffer, the packed conditioning copied into
its static buffers. ``capture=False`` keeps the eager loop (the card check's
reference and the A/B); on the CPU the eager loop runs.

The engine's settings are a plain dataclass (``ServeSettings``), so the serving
path imports nothing of the JAX package; ``settings_from_config`` and
``main`` read the repo's YAML configs through the port's own reader
(``sbgm_danra_tpu_torch/config.py``). As the JAX engine does
(``sbgm_danra_tpu/serve.py:63-65``, ``:188-189``), the settings carry the
back-transform of the generated field, built from the statistics files
(``transforms.back_transforms_for_config``), and ``generate`` answers in
physical units through it; where the statistics are missing it warns, and the
fields stay in normalised space. With ``load_ema`` (``training.load_ema``) the
engine loads the EMA weights of a training checkpoint: the port's own
(``training/checkpointing.py``) or a bridged ``.npz`` holding ``ema_params/``.
An fp32 model serves with TF32 off (``precision.exact_fp32``).

Spans (``utils/profiling.span``, recorded while a ``torch.profiler`` runs):
``serve.queued`` on each caller's thread, from a request's enqueue to the
dispatcher's pop (the coalescer's queue wait); on the dispatcher's thread
``serve.idle`` (the wait for arrivals on an empty queue) and one
``serve.dispatch`` a dispatch, holding ``serve.pack`` (rows, seeds,
generators, the conditioning's copies to the device), the sampler's
``sample.inputs`` / ``sample.replay`` (``sampling/graphs.py``),
``serve.sync`` (the host blocked until the card has finished) and
``serve.fetch`` (the copy out and the split into requests).
"""

from __future__ import annotations

import dataclasses
import functools
import json
import logging
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from sbgm_danra_tpu_torch.capture import use_graphs
from sbgm_danra_tpu_torch.config import get_model_string, load_config, parse_override
from sbgm_danra_tpu_torch.models.unet import ModelSpec, build_score_model, model_spec_from_config
from sbgm_danra_tpu_torch.precision import exact_fp32
from sbgm_danra_tpu_torch.sampling import graphs
from sbgm_danra_tpu_torch.sampling.samplers import (SamplerConfig, config_from_run, get_sampler,
                                                   pc_sampler)
from sbgm_danra_tpu_torch.sde import VESDE
from sbgm_danra_tpu_torch.transforms import Transform, back_transforms_for_config
from sbgm_danra_tpu_torch.utils.profiling import recording, span

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class ServeSettings:
    """What the engine reads from a run config."""

    spec: ModelSpec
    sampler_type: str
    sampler: SamplerConfig
    sample_hw: Tuple[int, int]
    n_lr: int  # LR condition channels
    model_string: str
    spread_calibration: Optional[float] = None
    back_transform: Optional[Transform] = None  # normalised -> physical units
    load_ema: bool = False


# configs/flagship_synth.yaml as the config readers make it (CPU tests hold
# this, the port's reading and the JAX package's reading equal): the
# 19.08M-parameter bf16 UNet at 128 px, dpmpp-25, CFG w=3.
FLAGSHIP_SYNTH = ServeSettings(
    spec=ModelSpec(in_channels=6, num_classes=4, compute_dtype="bfloat16"),
    sampler_type="dpmpp_sampler",
    sampler=SamplerConfig(num_steps=25, snr=0.16, eps=1e-3, guidance_scale=3.0),
    sample_hw=(128, 128),
    n_lr=2,
    model_string=(
        "flagship_synth__HR_prcp_DANRA__SIZE_128x128__LR_temp_prcp_ERA5__"
        "LOSS_sdfweighted__HEADS_4__TIMESTEPS_25"
    ),
    load_ema=True,
)


def settings_from_config(cfg) -> ServeSettings:
    """A loaded run config -> ServeSettings, as the JAX engine reads it."""
    s, rf = cfg.highres.data_size, cfg.lowres.resize_factor
    return ServeSettings(
        spec=model_spec_from_config(cfg),
        sampler_type=cfg.sampler.sampler_type,
        sampler=config_from_run(cfg, cfg.evaluation.n_steps),
        sample_hw=(s[0] // rf, s[1] // rf),
        n_lr=len(cfg.lowres.condition_variables or ()),
        model_string=get_model_string(cfg),
        spread_calibration=cfg.evaluation.spread_calibration,
        back_transform=back_transforms_for_config(cfg).get("generated"),
        load_ema=cfg.training.load_ema,
    )


def member_seed(seed: int, member: int) -> int:
    """The generator seed of member ``member`` of a request with ``seed``."""
    return int(np.random.SeedSequence([seed, member]).generate_state(1, np.uint64)[0])


def load_state_dict(source: Union[str, Mapping], model: torch.nn.Module,
                    use_ema: bool = False) -> Mapping:
    """The weights to serve: a state_dict as given, or loaded from a file.

    A file is a ``torch.save`` state_dict, a training checkpoint of the port
    (``training/checkpointing.py``; its EMA weights with ``use_ema``) or a
    bridged Flax ``.npz`` (``ema_params/`` in place of ``params/`` with
    ``use_ema``). ``use_ema`` on a checkpoint without EMA weights raises.
    """
    if not isinstance(source, str):
        return source
    if source.endswith(".npz"):
        from sbgm_danra_tpu_torch.convert import load_npz, state_dicts_from_flax

        params, ema = state_dicts_from_flax(load_npz(source), model)
        if use_ema and ema is None:
            raise KeyError(f"{source} holds no ema_params/ to load with load_ema")
        return ema if use_ema else params
    loaded = torch.load(source, map_location="cpu", weights_only=True)
    if "params" in loaded and "batch_stats" in loaded:  # a training checkpoint
        from sbgm_danra_tpu_torch.training.checkpointing import model_state_dict

        return model_state_dict(loaded, use_ema=use_ema)
    return loaded


class InferenceEngine:
    """Model weights on ``device`` -> conditional sampler at a fixed member capacity."""

    def __init__(self, settings: ServeSettings, state_dict: Union[str, Mapping],
                 device: Union[str, torch.device], max_members: int = 8,
                 capture: Optional[bool] = None):
        self.settings = settings
        self.device = torch.device(device)
        self.capture = use_graphs(capture, self.device)
        self.max_members = max_members
        self.hw = tuple(settings.sample_hw)
        self.model_string = settings.model_string
        if self.device.type == "cuda":
            # same algorithms on every dispatch: the co-batching guarantee
            torch.backends.cudnn.deterministic = True
            torch.backends.cudnn.benchmark = False
        model = build_score_model(settings.spec, VESDE())
        model.load_state_dict(load_state_dict(state_dict, model, use_ema=settings.load_ema))
        self.model = model.to(self.device).eval()
        self.sde = VESDE()
        self._sampler = get_sampler(settings.sampler_type)
        self.back_transform = settings.back_transform
        if self.back_transform is None:
            logger.warning("no back-transform for the generated field (statistics missing); "
                           "serving fields in normalized space")
        # serving-under-load observability: dispatches vs rows served
        self.n_dispatches = 0
        self.n_rows = 0
        self._batcher = _Batcher(self)

    def score_fn(self, x, t, **cond):
        return self.model(x, t, **cond)

    def _zero_row(self) -> Dict[str, np.ndarray]:
        """One all-zero condition row: the CFG-null protocol, also the default for omitted keys."""
        return {
            "y": np.zeros((), np.int64),
            "cond_img": np.zeros((*self.hw, self.settings.n_lr), np.float32),
            "lsm_cond": np.zeros((*self.hw, 2), np.float32),
            "topo_cond": np.zeros((*self.hw, 2), np.float32),
        }

    def warmup(self) -> float:
        """One full dispatch ahead of the first request; returns seconds.

        It runs on the dispatcher thread, which is where the per-thread
        library handles (cuBLAS, cuDNN) that requests need get created.
        """
        t0 = time.perf_counter()
        self._batcher.submit(_Ticket(0, self._zero_row(), self.max_members))
        self.n_dispatches = self.n_rows = 0
        return time.perf_counter() - t0

    def generate(
        self,
        conditions: Dict[str, np.ndarray],
        n_members: int = 1,
        seed: int = 0,
        spread_calibration: Optional[float] = None,
    ) -> np.ndarray:
        """Generate n_members fields for ONE condition dict.

        Thread-safe: concurrent calls are coalesced by the batcher. The result
        depends only on (seed, conditions), not on what it was co-batched with.
        """
        if n_members > self.max_members:
            raise ValueError(f"n_members {n_members} exceeds engine capacity {self.max_members}")
        if n_members < 1:
            raise ValueError(f"n_members must be >= 1, got {n_members}")
        row = self._zero_row()
        for key in ("y", "cond_img", "lsm_cond", "topo_cond"):
            v = conditions.get(key)
            if v is None:
                continue
            v = np.asarray(v, np.int64 if key == "y" else np.float32)
            if key != "y" and v.ndim == 4:
                v = v[0]
            if key == "y" and v.ndim > 0:
                v = v.reshape(-1)[0]
            if v.shape != row[key].shape:
                raise ValueError(f"{key}: shape {v.shape}, engine expects {row[key].shape}")
            row[key] = v
        out = self._batcher.submit(_Ticket(seed, row, n_members))
        alpha = (self.settings.spread_calibration if spread_calibration is None
                 else float(spread_calibration))
        if alpha is not None and n_members > 1:
            # normalized-space ensemble inflation about the member mean
            mean = out.mean(axis=0, keepdims=True)
            out = mean + alpha * (out - mean)
        if self.back_transform is not None:
            out = np.asarray(self.back_transform(out), np.float32)
        return out

    def _dispatch(self, tickets: List["_Ticket"]) -> None:
        """Pack the tickets' member rows into one fixed-capacity sampler call."""
        with span("serve.dispatch"):
            m = self.max_members
            with span("serve.pack"):
                cond = {k: np.broadcast_to(v, (m, *v.shape)).copy()
                        for k, v in self._zero_row().items()}
                seeds = [member_seed(0, i) for i in range(m)]  # filler rows
                i, slots = 0, []
                for t in tickets:
                    seeds[i : i + t.n] = [member_seed(t.seed, j) for j in range(t.n)]
                    for k, v in t.row.items():
                        cond[k][i : i + t.n] = v
                    slots.append((t, i, i + t.n))
                    i += t.n
                gens = [torch.Generator(self.device).manual_seed(s) for s in seeds]
                cond_t = {k: torch.from_numpy(v).to(self.device) for k, v in cond.items()}
            extra = {"per_member_step": True} if self._sampler is pc_sampler else {}
            run = (functools.partial(graphs.sample, self._sampler) if self.capture
                   else self._sampler)
            with exact_fp32(self.settings.spec.compute_dtype), torch.inference_mode():
                out = run(self.score_fn, gens, (m, *self.hw, 1), self.sde,
                          self.settings.sampler, cond=cond_t, **extra)
                with span("serve.sync"):
                    if self.device.type == "cuda":
                        torch.cuda.current_stream(self.device).synchronize()
                with span("serve.fetch"):
                    out = out[..., 0].float().cpu().numpy()
                    for t, lo, hi in slots:
                        t.out = out[lo:hi]
            self.n_dispatches += 1
            self.n_rows += i

    def close(self) -> None:
        self._batcher.close()


class _Ticket:
    __slots__ = ("seed", "row", "n", "event", "popped", "out", "err")

    def __init__(self, seed: int, row: Dict[str, np.ndarray], n: int):
        self.seed, self.row, self.n = seed, row, n
        self.event = threading.Event()
        # set when the dispatcher takes the ticket; made only while a
        # profiler records, to end the caller's ``serve.queued`` span
        self.popped: Optional[threading.Event] = None
        self.out = None
        self.err: Optional[BaseException] = None

    def pop(self) -> "_Ticket":
        if self.popped is not None:
            self.popped.set()
        return self


class _Batcher:
    """Greedy request coalescer: one dispatcher thread drains the queue into
    fixed-capacity dispatches. While a dispatch runs, arrivals queue and ride
    the next one, so an idle server adds no latency and a loaded one batches."""

    def __init__(self, engine: InferenceEngine):
        self._engine = engine
        self._cv = threading.Condition()
        self._queue: deque = deque()
        self._closed = False
        self._thread = threading.Thread(target=self._loop, daemon=True, name="serve-batcher")
        self._thread.start()

    def submit(self, ticket: _Ticket) -> np.ndarray:
        if recording():
            ticket.popped = threading.Event()
            with span("serve.queued"):
                self._enqueue(ticket)
                ticket.popped.wait()
        else:
            self._enqueue(ticket)
        ticket.event.wait()
        if ticket.err is not None:
            raise ticket.err
        return ticket.out

    def _enqueue(self, ticket: _Ticket) -> None:
        with self._cv:
            if self._closed:
                raise RuntimeError("engine is closed")
            self._queue.append(ticket)
            self._cv.notify()

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify()
        self._thread.join(timeout=60)

    def _loop(self) -> None:
        while True:
            with self._cv:
                if not self._queue and not self._closed:
                    with span("serve.idle"):
                        while not self._queue and not self._closed:
                            self._cv.wait()
                if self._closed:
                    for t in self._queue:
                        t.err = RuntimeError("engine closed")
                        t.pop().event.set()
                    return
                batch, cap = [], self._engine.max_members
                while self._queue and self._queue[0].n <= cap:
                    t = self._queue.popleft().pop()
                    batch.append(t)
                    cap -= t.n
            try:
                self._engine._dispatch(batch)
            except BaseException as e:  # surfaced on the caller's thread
                for t in batch:
                    t.err = e
            finally:
                for t in batch:
                    t.event.set()


def make_handler(engine: InferenceEngine):
    class Handler(BaseHTTPRequestHandler):
        def _reply(self, code: int, payload: Dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path != "/healthz":
                self._reply(404, {"error": f"unknown path {self.path}"})
                return
            self._reply(200, {
                "status": "ok",
                "model": engine.model_string,
                "platform": engine.device.type,
                "max_members": engine.max_members,
                "sample_hw": list(engine.hw),
                "n_dispatches": engine.n_dispatches,
                "n_rows_served": engine.n_rows,
                "mean_rows_per_dispatch": round(engine.n_rows / max(1, engine.n_dispatches), 2),
            })

        def do_POST(self):
            if self.path != "/generate":
                self._reply(404, {"error": f"unknown path {self.path}"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
                raw = req.get("conditions") or {}
                conditions = {k: np.asarray(v, np.float32) for k, v in raw.items()
                              if k in ("cond_img", "lsm_cond", "topo_cond")}
                if "y" in raw:
                    conditions["y"] = np.asarray(raw["y"], np.int64)
                t0 = time.perf_counter()
                sc = req.get("spread_calibration")
                out = engine.generate(
                    conditions,
                    n_members=int(req.get("n_members", 1)),
                    seed=int(req.get("seed", 0)),
                    spread_calibration=None if sc is None else float(sc),
                )
                self._reply(200, {
                    "generated": out.tolist(),
                    "shape": list(out.shape),
                    "latency_s": round(time.perf_counter() - t0, 3),
                })
            except (ValueError, KeyError, json.JSONDecodeError) as e:
                self._reply(400, {"error": str(e)})
            except Exception as e:  # a boundary that must keep serving
                logger.exception("generation failed")
                self._reply(500, {"error": str(e)})

        def log_message(self, fmt, *args):
            logger.info("%s " + fmt, self.client_address[0], *args)

    return Handler


def serve(settings: ServeSettings, state_dict: Union[str, Mapping], device: str,
          host: str = "127.0.0.1", port: int = 8901, max_members: int = 8) -> None:
    engine = InferenceEngine(settings, state_dict, device, max_members=max_members)
    dt = engine.warmup()
    logger.info("warmup dispatch took %.1fs; serving on %s:%d", dt, host, port)
    server = ThreadingHTTPServer((host, port), make_handler(engine))
    try:
        server.serve_forever()
    finally:
        server.server_close()
        engine.close()


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description="SBGM inference server (torch port)")
    p.add_argument("--config_path", required=True)
    p.add_argument("--checkpoint", required=True,
                   help="torch.save state_dict (.pt) or bridged Flax variables (.npz)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8901)
    p.add_argument("--max_members", type=int, default=8)
    p.add_argument("overrides", nargs="*")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    cfg = load_config(args.config_path, dict(parse_override(s) for s in args.overrides))
    serve(settings_from_config(cfg), args.checkpoint, args.device, args.host, args.port,
          args.max_members)


if __name__ == "__main__":
    main()
