"""Dry-run of every (arch x input-shape x mesh) pair on ``meta`` tensors
(port of ``repro/launch/dryrun.py``).

The reference lowers and compiles each pair's step for 256 or 512 TPU
placeholder devices and reads FLOPs, bytes, collectives and memory from
XLA.  The port lowers nothing: it runs the same step once, eagerly, on
``meta`` tensors at full size (``count_step``), which allocates nothing and
computes nothing, and counts what the step does as it goes:

* ``flops``: ``torch.utils.flop_counter.FlopCounterMode``'s products over
  the forward and backward, plus one FLOP an output element of each
  pointwise operation, remat's recompute included (the reference's cost
  artifacts keep remat too), every layer unrolled;
* ``bytes``: each operation's operand and result bytes (a
  ``TorchDispatchMode``; views move nothing).  That is the eager port's own
  traffic, no fusion assumed;
* ``peak_live_bytes``: the most bytes that tensors made inside the step held
  at once, from each storage's lifetime (activations kept for the backward,
  the inputs remat keeps, the gradients and every temporary);
* ``saved_bytes``: tensors autograd saved for the backward outside remat's
  checkpointed pieces (``torch.autograd.graph.saved_tensors_hooks``;
  a checkpointed piece keeps only its inputs, so this is where remat shows).

``run_pair`` turns one count into the reference's record under the
production mesh's rules (``sharding.specs``):

* exact, the reference's own: ``params`` and ``model_flops_per_token``
  (``models.config``), ``prepare_config``, and each leaf's spec and block
  shape, hence ``memory.argument_bytes`` (params, optimizer state, batch or
  decode state: every leaf's block under its spec);
* port-side estimates: ``hlo_flops_per_device`` and ``hlo_bytes_per_device``
  (the count split evenly over the mesh's devices), ``memory.temp_bytes``
  (``peak_live_bytes`` split likewise), ``memory.output_bytes``, and
  ``collectives``: the bytes a device moves for the FSDP all-gathers of the
  params (again in the backward), the reduce-scatters of the gradients, the
  all-reduce of the gradients over pods, the tensor-parallel all-reduce of
  each block output whose contraction the model axis splits, and the MoE
  dispatch and combine all-to-all, each from the leaf's spec.

``collective_bytes_from_hlo`` has no counterpart: the port lowers no HLO.
``current_mesh()`` stays unset while counting: ``lm_loss`` refuses a model
axis (ROADMAP.md item A8), and no whole model runs sharded on one card.

``make_step`` returns torch step functions that also run for real, on the
CPU or the card at small sizes (``chip_smoke.py``'s ``dryrun`` phase runs
the train step on the card through the flash and scan kernels).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-32b --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both --out results/dryrun.jsonl
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time
import weakref
from typing import Any, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import SHAPES, get_config, list_archs
from repro_torch.launch.mesh import HARDWARE, make_production_mesh
from repro_torch.launch.train import loss_and_grads
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig, apply_retention, flops_per_token, param_count
from repro_torch.models.layers import SHAPE_ONLY
from repro_torch.optim.optimizers import adamw, tree_leaves, tree_map
from repro_torch.sharding import specs as S
from repro_torch.sharding.specs import batch_pspecs, decode_state_pspecs, param_pspec, tree_pspecs

__all__ = [
    "WHISPER_ENC_FRAMES",
    "long_500k_eligible",
    "prepare_config",
    "input_specs",
    "make_step",
    "accumulated_grads",
    "argument_bytes",
    "count_pair",
    "record",
    "opt_pspec",
    "block_shape",
    "block_bytes",
    "ONE_DEVICE",
    "StepCount",
    "count_step",
    "collective_bytes",
    "run_pair",
    "main",
    "EXACT_FIELDS",
    "ESTIMATED_FIELDS",
]

WHISPER_ENC_FRAMES = 1500  # 30 s of audio at 50 Hz post-conv (Whisper native)

# which fields of a record are the reference's own figures and which the port's estimates
EXACT_FIELDS = ("params", "model_flops_per_token", "memory.argument_bytes")
ESTIMATED_FIELDS = ("hlo_flops_per_device", "hlo_bytes_per_device", "collectives",
                    "memory.temp_bytes", "memory.output_bytes", "memory.peak_bytes")


def long_500k_eligible(cfg: ModelConfig, variant: Optional[str]) -> bool:
    """Sub-quadratic rule (DESIGN.md §5): every layer must be windowed or
    recurrent at decode time."""
    kinds = set(cfg.layer_kinds())
    if cfg.encoder_layers:
        return False  # enc-dec cross attention over full encoder output
    if variant == "windowed":
        return True
    return kinds <= {"rglru", "local", "mlstm", "slstm", "moe_local"}


def prepare_config(
    arch: str,
    shape_name: str,
    *,
    retention: float = 1.0,
    variant: Optional[str] = None,
    dtype: str = "bfloat16",
    scan_layers: bool = True,
    remat: bool = True,
    q_block: Optional[int] = 1024,
    num_layers: Optional[int] = None,
    seq_shard: bool = False,
) -> ModelConfig:
    cfg = get_config(arch)
    if variant == "windowed":
        pattern = tuple(
            {"attn": "local", "moe": "moe_local"}.get(k, k) for k in cfg.block_pattern
        )
        cfg = cfg.replace(block_pattern=pattern,
                          window_size=cfg.window_size or 4096)
    if retention < 1.0:
        cfg = apply_retention(cfg, retention)
    kw: Dict[str, Any] = dict(dtype=dtype, scan_layers=scan_layers, remat=remat,
                              attn_q_block=q_block,
                              seq_shard_activations=seq_shard)
    if num_layers is not None:
        kw["num_layers"] = num_layers
    if shape_name == "decode_32k" and cfg.pos_embed == "learned":
        kw["max_position"] = 32_768 + 8
    # pad vocab to a model-axis-shardable multiple (logits masked above real)
    if cfg.vocab_size % 256 != 0:
        kw["vocab_size_real"] = cfg.vocab_size
        kw["vocab_size"] = ((cfg.vocab_size + 255) // 256) * 256
    return cfg.replace(**kw)


# ---------------------------------------------------------------------------
# the step's inputs and the step
# ---------------------------------------------------------------------------

def _empty(shape, dtype, device):
    return torch.empty(tuple(shape), dtype=dtype, device=device)


def input_specs(cfg: ModelConfig, shape_name: str, mesh, *, device="meta",
                batch: Optional[int] = None, seq: Optional[int] = None) -> Dict[str, Any]:
    """Stand-ins for every input of the step the shape's kind selects:
    ``{"batch": {...}}`` (train, prefill) or ``{"state", "token"}``
    (decode), ``meta`` tensors of the reference's global shapes and dtypes,
    and under ``"pspecs"`` the same tree of their specs on ``mesh``
    (``batch_pspecs`` / ``decode_state_pspecs``).  ``batch`` / ``seq``
    replace the shape's global batch and length (a step run for real at a
    small size; the encoder then takes ``seq`` frames)."""
    shp = SHAPES[shape_name]
    B = shp.global_batch if batch is None else batch
    L = shp.seq_len if seq is None else seq
    dt = T.param_dtype(cfg)
    frames = WHISPER_ENC_FRAMES if seq is None else seq
    if shp.kind in ("train", "prefill"):
        n_prefix = cfg.num_prefix_embeds
        shapes = {"tokens": ((B, L - n_prefix), torch.int32)}
        if n_prefix:
            shapes["prefix_embeds"] = ((B, n_prefix, cfg.d_model), dt)
        if cfg.encoder_layers:
            shapes["enc_embeds"] = ((B, frames, cfg.d_model), dt)
        out = {k: _empty(s, d, device) for k, (s, d) in shapes.items()}
        return {"batch": out, "pspecs": {"batch": {k: batch_pspecs(k, s, mesh)
                                                   for k, (s, _) in shapes.items()}}}
    # decode: one token against a cache of L
    enc_len = frames if cfg.encoder_layers else 0
    state = T.init_decode_state(cfg, B, L, enc_len=enc_len, device=device)
    token = _empty((B,), torch.int32, device)
    return {"state": state, "token": token,
            "pspecs": {"state": tree_pspecs(state["caches"], mesh, decode_state_pspecs),
                       "token": batch_pspecs("token", (B,), mesh)}}


def opt_pspec(path: str, shape, mesh):
    """The optimizer state's rule: ``m/...`` and ``v/...`` as the param at
    ``...``; the step count replicated (the reference's lambda)."""
    return param_pspec(path.split("/", 1)[-1] if "/" in path else path, shape, mesh)


def make_step(cfg: ModelConfig, shape_name: str, optimizer="adamw",
              opt_dtype="float32", microbatch: int = 1):
    """Returns ``(step_fn, abstract_args)``, as the reference's.

    ``step_fn`` is the shape kind's torch step: train ``(params, opt_state,
    batch) -> (params, opt_state, loss)`` (the loss and grads of
    ``lm_loss``, then AdamW at 3e-4 with ``m`` / ``v`` in ``opt_dtype``;
    the params and the state are updated in place), prefill ``(params,
    batch) -> (logits, state)`` (a cache of the shape's length) or decode
    ``(params, state, token) -> (logits, state)``.  ``microbatch=k`` splits
    the batch into ``k`` sequential chunks whose losses and gradients are
    summed from float32 zeros in chunk order and divided by ``k``, the
    reference's ``lax.scan``.  ``abstract_args(mesh, device="meta",
    batch=None, seq=None)`` builds the step's arguments: params from the
    shape-only init (``SHAPE_ONLY``) on ``meta``, else from a seeded
    generator on ``device``, the optimizer's zero state, and
    ``input_specs``' inputs (real zeros off ``meta``)."""
    if optimizer != "adamw":
        raise ValueError(f"make_step: the dry-run's optimizer is adamw, got {optimizer!r}")
    shp = SHAPES[shape_name]
    opt = adamw(3e-4, state_dtype=T.DTYPES[opt_dtype])

    if shp.kind == "train":
        def train_step(params, opt_state, batch):
            loss, grads = accumulated_grads(params, cfg, batch, microbatch)
            with torch.no_grad():
                opt_state = opt.step_(params, grads, opt_state)
            return params, opt_state, loss

        def abstract_args(mesh=None, device="meta", batch=None, seq=None):
            params = _params(cfg, device)
            return (params, opt.init(params),
                    _inputs(cfg, shape_name, mesh, device, batch, seq)["batch"])

        return train_step, abstract_args

    if shp.kind == "prefill":
        def prefill_step(params, batch):
            return T.prefill(params, cfg, batch, max_len=SHAPES[shape_name].seq_len)

        def abstract_args(mesh=None, device="meta", batch=None, seq=None):
            return (_params(cfg, device), _inputs(cfg, shape_name, mesh, device, batch, seq)["batch"])

        return prefill_step, abstract_args

    def serve_step(params, state, token):
        return T.decode_step(params, cfg, state, token)

    def abstract_args(mesh=None, device="meta", batch=None, seq=None):
        specs = _inputs(cfg, shape_name, mesh, device, batch, seq)
        return (_params(cfg, device), specs["state"], specs["token"])

    return serve_step, abstract_args


def accumulated_grads(params, cfg: ModelConfig, batch, microbatch: int = 1):
    """``(loss, grads)`` of ``lm_loss`` over ``batch`` in ``microbatch``
    sequential chunks: at ``microbatch > 1`` each chunk's loss and
    gradients summed from float32 zeros in chunk order, then divided by
    ``microbatch`` (the reference train step's ``lax.scan``)."""
    if microbatch == 1:
        return loss_and_grads(params, cfg, batch)
    dev = batch["tokens"].device
    loss = torch.zeros((), dtype=torch.float32, device=dev)
    grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)
    for i in range(microbatch):
        mb = {k: v.reshape(microbatch, v.shape[0] // microbatch, *v.shape[1:])[i]
              for k, v in batch.items()}
        mb_loss, mb_grads = loss_and_grads(params, cfg, mb)
        loss = loss + mb_loss
        grads = tree_map(torch.add, grads, mb_grads)
        del mb_grads
    return loss / microbatch, tree_map(lambda g: g / microbatch, grads)


def _params(cfg: ModelConfig, device):
    dev = torch.device(device)
    gen = SHAPE_ONLY if dev.type == "meta" else torch.Generator(device=dev).manual_seed(0)
    return T.init_params(gen, cfg)


def _inputs(cfg, shape_name, mesh, device, batch, seq):
    out = input_specs(cfg, shape_name, mesh if mesh is not None else ONE_DEVICE, device="meta",
                      batch=batch, seq=seq)
    if torch.device(device).type != "meta":
        # real inputs: zeros of the same shapes and dtypes
        out = {k: (v if k == "pspecs" else T.tree_map(
            lambda t: torch.zeros(t.shape, dtype=t.dtype, device=device)
            if isinstance(t, torch.Tensor) else t, v)) for k, v in out.items()}
    return out


class _OneDevice:
    """A mesh of one device: every rule's axis of size 1."""

    shape = {"data": 1, "model": 1}


ONE_DEVICE = _OneDevice()


# ---------------------------------------------------------------------------
# block shapes under the rules
# ---------------------------------------------------------------------------

def _axis_size(mesh, axis) -> int:
    if axis is None:
        return 1
    return math.prod(mesh.shape[a] for a in (axis if isinstance(axis, tuple) else (axis,)))


def block_shape(shape, spec, mesh):
    """The block of a ``shape`` leaf that one device holds under ``spec``
    (``NamedSharding.shard_shape``; the rules only shard what divides)."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(n // _axis_size(mesh, a) for n, a in zip(shape, spec))


def block_bytes(tree, specs, mesh) -> int:
    """Bytes a device holds of ``tree`` under the same-structured ``specs``."""
    leaves, specs_flat = tree_leaves(tree), []
    _spec_leaves(specs, specs_flat)
    if len(leaves) != len(specs_flat):
        raise ValueError(f"{len(leaves)} leaves against {len(specs_flat)} specs")
    return sum(math.prod(block_shape(t.shape, s, mesh)) * t.element_size()
               for t, s in zip(leaves, specs_flat))


def _spec_leaves(specs, out):
    if isinstance(specs, dict):
        for v in specs.values():
            _spec_leaves(v, out)
    elif isinstance(specs, list):
        for v in specs:
            _spec_leaves(v, out)
    else:
        out.append(specs)


# ---------------------------------------------------------------------------
# the count
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class StepCount:
    """What one run of a step did, on one device, unsharded: ``flops`` are
    the products' (``FlopCounterMode``) and one an output element of each
    pointwise operation (as XLA counts them)."""

    flops: int
    product_flops: int
    bytes: int
    ops: int
    peak_live_bytes: int
    saved_bytes: int
    output_bytes: int
    seconds: float


_NO_TRAFFIC = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided"}


class _Traffic(TorchDispatchMode):
    """Sums each operation's operand and result bytes (views and bare
    allocations move none) and follows the bytes held by the storages that
    operations make, to their peak."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.ops = 0
        self.pointwise_flops = 0
        self.live = 0
        self.peak = 0
        self._refs: Dict[int, list] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
        self.ops += 1
        if torch.Tag.pointwise in func.tags:
            self.pointwise_flops += sum(t.numel() for t in outs)
        ins = [t for t in tree_flatten((args, kwargs))[0] if isinstance(t, torch.Tensor)]
        if not func.is_view and func.overloadpacket.__name__ not in _NO_TRAFFIC:
            self.bytes += sum(t.numel() * t.element_size() for t in ins + outs)
        aliased = {t.untyped_storage()._cdata for t in ins}
        for t in outs:
            self._track(t, t.untyped_storage()._cdata in aliased)
        return out

    def _track(self, t: torch.Tensor, alias: bool) -> None:
        """Count a storage that an operation made.  An output on an input's
        storage (a view, an in-place or ``out=`` result) keeps that storage
        alive, but one on a tensor made before the step (a param, the
        optimizer's state, an input) holds nothing new."""
        st = t.untyped_storage()
        key = st._cdata
        ref = self._refs.get(key)
        if ref is None:
            if alias:
                return
            ref = self._refs[key] = [0, st.nbytes()]
            self.live += ref[1]
            self.peak = max(self.peak, self.live)
        ref[0] += 1
        weakref.finalize(t, self._drop, key)

    def _drop(self, key: int) -> None:
        ref = self._refs.get(key)
        if ref is None:
            return
        ref[0] -= 1
        if ref[0] == 0:
            self.live -= ref[1]
            del self._refs[key]


def _tensor_bytes(tree) -> int:
    seen, total = set(), 0
    for t in tree_flatten(tree)[0]:
        if isinstance(t, torch.Tensor) and id(t) not in seen:
            seen.add(id(t))
            total += t.numel() * t.element_size()
    return total


def count_step(step, args) -> StepCount:
    """Run ``step(*args)`` once under the counters (module docstring).  On
    ``meta`` arguments it allocates and computes nothing; on real ones it
    counts the same operations (the tests hold the two counts equal)."""
    saved: Dict[int, int] = {}

    def pack(t):
        saved.setdefault(t.untyped_storage()._cdata, t.untyped_storage().nbytes())
        return t

    t0 = time.perf_counter()
    flops = FlopCounterMode(display=False)
    traffic = _Traffic()
    with flops, traffic, torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = step(*args)
        out_bytes = _tensor_bytes(out)
        del out
    return StepCount(flops=int(flops.get_total_flops()) + traffic.pointwise_flops,
                     product_flops=int(flops.get_total_flops()), bytes=int(traffic.bytes),
                     ops=traffic.ops, peak_live_bytes=int(traffic.peak),
                     saved_bytes=int(sum(saved.values())), output_bytes=int(out_bytes),
                     seconds=time.perf_counter() - t0)


# ---------------------------------------------------------------------------
# collectives implied by the rules
# ---------------------------------------------------------------------------

_COLL_OPS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all", "collective-permute")
# row-parallel products: the leaf's contraction dims (after any stacked axis)
# that, split over the model axis, leave a partial sum of the block output
_ROW_PARALLEL = {"wo": (0, 1), "w_down": (0,), "ws_down": (0,), "w_out": (0,)}


def _walk(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, path + (str(k),))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _walk(v, path + (str(i),))
    else:
        yield "/".join(path), tree


def collective_bytes(cfg: ModelConfig, shape_name: str, params, mesh, *, microbatch: int = 1,
                     act_tokens: Optional[int] = None) -> Dict[str, float]:
    """Bytes one device moves in each kind of collective, as the rules
    place the step (module docstring); estimates, with the reference's keys.

    Per parameter leaf ``P`` bytes, split ``n_d`` ways over ``data`` (the
    FSDP axes: ``data`` and, under ``FULL_DP``, ``model``) and ``n_m`` over
    the rest: an all-gather of ``P/n_m (n_d-1)/n_d`` per forward (twice a
    train step: again in the backward, ZeRO-3), per train step a
    reduce-scatter of its gradient of the same size, and over ``pod`` an
    all-reduce of the gradient block, ``2 (n_p-1)/n_p P/(n_d n_m)``.  Per
    row-parallel product split over ``model`` (``_ROW_PARALLEL``) an
    all-reduce of the block output, ``2 (n_m-1)/n_m`` times its local
    tokens x d_model; per MoE layer with experts split over ``model`` an
    all-to-all of the tokens' ``k`` copies out and back.  A train step runs
    the forward's activation collectives again in its backward and, under
    remat, in the recompute; ``microbatch`` repeats the gathers."""
    shp = SHAPES[shape_name]
    out = {op: 0.0 for op in _COLL_OPS}
    out["count"] = 0
    if not mesh.shape:
        out["total"] = 0.0
        return out
    train = shp.kind == "train"
    n_pod = mesh.shape.get("pod", 1)
    fsdp_axes = ("data", "model") if S.FULL_DP else ("data",)
    passes = (2 if train else 1) * (microbatch if train else 1)
    for path, t in _walk(params):
        spec = param_pspec(path, tuple(t.shape), mesh)
        spec = tuple(spec) + (None,) * (t.dim() - len(spec))
        n_d = n_m = 1
        for a in spec:
            for ax in (a if isinstance(a, tuple) else (a,)):
                if ax is None:
                    continue
                if ax in fsdp_axes:
                    n_d *= mesh.shape[ax]
                else:
                    n_m *= mesh.shape[ax]
        P = t.numel() * t.element_size()
        if n_d > 1:
            g = P / n_m * (n_d - 1) / n_d
            out["all-gather"] += passes * g
            out["count"] += passes
            if train:
                out["reduce-scatter"] += g
                out["count"] += 1
        if train and n_pod > 1:
            out["all-reduce"] += 2 * (n_pod - 1) / n_pod * P / (n_d * n_m)
            out["count"] += 1
    # activations: tokens a device holds (the batch split over its axes)
    n_model = mesh.shape.get("model", 1)
    if n_model > 1 and not S.FULL_DP:
        tokens = act_tokens
        if tokens is None:
            tokens = shp.global_batch * (shp.seq_len if shp.kind != "decode" else 1)
        n_batch = _axis_size(mesh, S._batch_axes(mesh))
        act = tokens / n_batch * cfg.d_model * T.param_dtype(cfg).itemsize
        runs = (3 if cfg.remat else 2) if train else 1
        for path, t in _walk(params):
            name = path.split("/")[-1]
            if name not in _ROW_PARALLEL and not (name == "w_gate" and "moe" in path):
                continue
            stk = 1 if path.startswith(("blocks", "enc_blocks")) else 0
            layers = t.shape[0] if stk else 1
            spec = param_pspec(path, tuple(t.shape), mesh)
            spec = tuple(spec) + (None,) * (t.dim() - len(spec))
            if name == "w_gate":       # MoE experts split over model: dispatch and combine
                if spec[stk] == "model":
                    k = cfg.experts_per_tok
                    out["all-to-all"] += runs * layers * 2 * k * act * (n_model - 1) / n_model
                    out["count"] += runs * layers * 2
                continue
            if "moe" in path and name == "w_down":
                continue               # the experts' outputs return by the all-to-all
            dims = [stk + d for d in _ROW_PARALLEL[name]]
            if any(spec[d] == "model" for d in dims):
                out["all-reduce"] += runs * layers * 2 * (n_model - 1) / n_model * act
                out["count"] += runs * layers
    out["total"] = sum(out[op] for op in _COLL_OPS)
    return out


# ---------------------------------------------------------------------------
# one pair
# ---------------------------------------------------------------------------

def argument_bytes(cfg, shape_name, args, mesh) -> int:
    """The bytes a device holds of the step's arguments ``args`` under
    ``mesh``'s rules: each leaf's block under its spec (exact)."""
    kind = SHAPES[shape_name].kind
    params = args[0]
    total = block_bytes(params, tree_pspecs(params, mesh, param_pspec), mesh)
    if kind == "train":
        state = args[1]
        total += block_bytes(state, tree_pspecs(state, mesh, opt_pspec), mesh)
        batch = args[2]
        total += block_bytes(batch, {k: batch_pspecs(k, tuple(v.shape), mesh)
                                     for k, v in batch.items()}, mesh)
    elif kind == "prefill":
        batch = args[1]
        total += block_bytes(batch, {k: batch_pspecs(k, tuple(v.shape), mesh)
                                     for k, v in batch.items()}, mesh)
    else:
        caches = args[1]["caches"]
        total += block_bytes(caches, tree_pspecs(caches, mesh, decode_state_pspecs), mesh)
        total += block_bytes(args[2], batch_pspecs("token", tuple(args[2].shape), mesh), mesh)
    return int(total)


def count_pair(cfg: ModelConfig, shape_name: str, mesh, *, opt_dtype: str = "float32",
               microbatch: int = 1):
    """``(count, args)``: the step of ``cfg`` at ``shape_name`` counted once
    on ``meta`` at full size."""
    step, abstract_args = make_step(cfg, shape_name, opt_dtype=opt_dtype, microbatch=microbatch)
    args = abstract_args(mesh)
    return count_step(step, args), args


def record(cfg: ModelConfig, shape_name: str, mesh, count: StepCount, args, *,
           microbatch: int = 1) -> Dict[str, Any]:
    """The per-device figures of a counted pair under ``mesh``'s rules."""
    n_dev = int(math.prod(mesh.shape.values())) if mesh.shape else 1
    arg_bytes = argument_bytes(cfg, shape_name, args, mesh)
    temp = count.peak_live_bytes / n_dev
    coll = collective_bytes(cfg, shape_name, args[0], mesh, microbatch=microbatch)
    return {
        "devices": n_dev,
        "params": param_count(cfg),
        "model_flops_per_token": flops_per_token(cfg, SHAPES[shape_name].seq_len),
        "hlo_flops_per_device": count.flops / n_dev,
        "hlo_bytes_per_device": count.bytes / n_dev,
        "collectives": coll,
        "collective_link": f"NVLink 4, {HARDWARE['nvlink_bandwidth'] / 1e9:.0f} GB/s each way "
                           f"({HARDWARE['name']} datasheet)",
        "memory": {
            "argument_bytes": arg_bytes,
            "output_bytes": count.output_bytes / n_dev,
            "temp_bytes": temp,
            "peak_bytes": arg_bytes + temp,
            "saved_bytes": count.saved_bytes / n_dev,
        },
        "count": dataclasses.asdict(count),
        "exact_fields": list(EXACT_FIELDS),
        "estimated_fields": list(ESTIMATED_FIELDS),
    }


def run_pair(
    arch: str,
    shape_name: str,
    mesh_kind: str = "single",
    *,
    retention: float = 1.0,
    variant: Optional[str] = None,
    verbose: bool = True,
) -> Dict[str, Any]:
    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"))
    cfg = prepare_config(arch, shape_name, retention=retention, variant=variant)
    if shape_name == "long_500k" and not long_500k_eligible(cfg, variant):
        return {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                "status": "skipped", "reason": "quadratic attention at 500k (DESIGN.md §5)"}
    count, args = count_pair(cfg, shape_name, mesh)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind, "retention": retention,
           "variant": variant, "status": "ok", "compile_s": round(count.seconds, 2)}
    rec.update(record(cfg, shape_name, mesh, count, args))
    if verbose:
        coll = rec["collectives"]
        print(
            f"[dryrun] {arch} x {shape_name} x {mesh_kind}({rec['devices']}) "
            f"retention={retention} count={count.seconds:.1f}s "
            f"temp={rec['memory']['temp_bytes']/2**30:.2f}GiB "
            f"args={rec['memory']['argument_bytes']/2**30:.2f}GiB "
            f"flops/dev={rec['hlo_flops_per_device']:.3g} "
            f"coll={coll['total']/2**20:.1f}MiB/{int(coll['count'])}ops"
        )
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--retention", type=float, default=1.0)
    ap.add_argument("--variant", default=None, choices=[None, "windowed"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None, help="JSONL output path")
    args = ap.parse_args(argv)

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    archs = list_archs() if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) else [args.shape]

    t0 = time.perf_counter()
    records = []
    for mesh_kind in meshes:
        for arch in archs:
            for shape in shapes:
                variant = args.variant
                if shape == "long_500k" and arch == "granite-moe-1b-a400m" and variant is None:
                    variant = "windowed"  # demonstrate the dense windowed variant
                try:
                    rec = run_pair(arch, shape, mesh_kind,
                                   retention=args.retention, variant=variant)
                except Exception as e:  # a failure here is a sharding bug
                    rec = {"arch": arch, "shape": shape, "mesh": mesh_kind,
                           "status": "FAILED", "error": f"{type(e).__name__}: {e}"}
                    print(f"[dryrun] FAILED {arch} x {shape} x {mesh_kind}: {e}")
                records.append(rec)
                if args.out:
                    with open(args.out, "a") as f:
                        f.write(json.dumps(rec) + "\n")
    n_ok = sum(r["status"] == "ok" for r in records)
    n_skip = sum(r["status"] == "skipped" for r in records)
    n_fail = len(records) - n_ok - n_skip
    print(f"[dryrun] done: {n_ok} ok, {n_skip} skipped, {n_fail} failed "
          f"in {time.perf_counter() - t0:.1f}s")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
