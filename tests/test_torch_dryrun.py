"""The port's dry-run and roofline tooling (``launch/dryrun.py``,
``launch/roofline.py``, ``bench/hillclimb.py``, ``bench/run.roofline_table``)
against the JAX package, on the CPU.

* ``prepare_config`` (every field) and ``long_500k_eligible`` for every arch
  x shape x retention {1.0, 0.6, 0.3} x variant {None, windowed}: exact;
* ``input_specs``: every input's global shape, dtype and spec on a (2, 4)
  mesh against the reference's ``ShapeDtypeStruct`` and ``NamedSharding``
  (``jax.make_mesh`` on the 8 virtual CPU devices): exact;
* ``make_step`` against the reference's step functions, jitted with no
  mesh, on smoke configs from one converted init: train at microbatch 1 and
  2 and with AdamW's ``m`` / ``v`` in float32 and bf16, at
  ``tests/test_torch_train.py``'s bars (the loss within 1e-5 relative;
  ``m`` within 1e-5 of its max, as the gradients, ``v`` within 2e-5, and a
  bf16 state one bf16 ulp (2**-7 relative) further: a float32 gap within
  those bars may round to the neighbouring bf16 value; the new params
  within ``2 * lr`` and at most 1e-4 of them further than 1e-6 apart, the
  1e-6 widened under a bf16 state by what one bf16 ulp of it moves AdamW's
  first update, ``2 * 2**-7 * lr``);
* prefill (logits 1e-4, caches 1e-4) and decode (logits 1e-4) of smoke
  recurrentgemma and whisper;
* the count: the products' FLOPs of a step on ``meta`` equal to those of
  the same step on CPU tensors (and the pointwise FLOPs and bytes, without
  the scan, whose ``meta`` route is shape-only); the count at ``k`` periods at full size equal to
  ``outer + k * per_period`` exactly; ``useful_flops_ratio <= 1``; each
  record carrying the reference's keys;
* each kernel wrapper's ``meta`` route, forward and backward, bf16 too:
  shapes and dtypes on ``meta``, no launch, the products seen by
  ``FlopCounterMode``;
* ``hillclimb.PAIRS`` equal to the reference's, and ``roofline_table``'s
  output byte for byte the reference's on the same port-written file.

The card's check of the argument bytes is ``tests/test_torch_dryrun_card.py``.
"""
import ast
import dataclasses
import json
import os
import pathlib
import sys

import jax

jax.devices()   # the backend starts on the conftest's devices before the reference's dry-run
_flags = os.environ.get("XLA_FLAGS")
from repro.launch import dryrun as JD   # noqa: E402  (sets XLA_FLAGS for its own processes)

if _flags is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _flags
import jax.numpy as jnp   # noqa: E402
import numpy as np   # noqa: E402
import pytest   # noqa: E402
import torch   # noqa: E402
from torch.utils.flop_counter import FlopCounterMode   # noqa: E402

from repro.configs import SHAPES, list_archs   # noqa: E402
from repro.configs import smoke_config as j_smoke_config   # noqa: E402
from repro.optim import optimizers as j_opt   # noqa: E402
from repro_torch import configs as t_configs   # noqa: E402
from repro_torch.bench import hillclimb as thc   # noqa: E402
from repro_torch.bench import run as trun   # noqa: E402
from repro_torch.convert import tree_to_numpy   # noqa: E402
from repro_torch.kernels import flash_attention as fa_mod   # noqa: E402
from repro_torch.kernels import pruned_matmul as pm_mod   # noqa: E402
from repro_torch.kernels import rg_lru_scan as rg_mod   # noqa: E402
from repro_torch.launch import dryrun as TD   # noqa: E402
from repro_torch.launch import roofline as TR   # noqa: E402
from repro_torch.models.config import flops_per_token, param_count   # noqa: E402
from repro_torch.optim import optimizers as t_opt   # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The models here are tiny: one intra-op thread beats a pool of them,
    which only contends with the suite's other workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ROOT = pathlib.Path(__file__).resolve().parents[1]
LOSS_TOL = 1e-5
GRAD_TOL = 1e-5
LOGIT_TOL = 1e-4
CACHE_TOL = 1e-4
FLIP_SHARE = 1e-4
LR = 3e-4
BF16_ROUND = 2.0 ** -7   # one bf16 ulp, relative


class FakeMesh:
    def __init__(self, **axes):
        self.shape = dict(axes)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _leaves(port, ref, path="root"):
    """(path, port leaf, reference leaf) over the reference tree."""
    if isinstance(ref, dict):
        assert set(port) == set(ref), path
        for k in ref:
            yield from _leaves(port[k], ref[k], f"{path}/{k}")
    elif isinstance(ref, list):
        assert len(port) == len(ref), path
        for i, (p, r) in enumerate(zip(port, ref)):
            yield from _leaves(p, r, f"{path}/{i}")
    else:   # a leaf (a port spec is a tuple)
        yield path, port, ref


# ---------------------------------------------------------------------------
# prepare_config, long_500k_eligible, input_specs
# ---------------------------------------------------------------------------

def test_prepare_config_and_long_500k_eligible_equal_the_reference():
    n = 0
    for arch in list_archs():
        for shape in SHAPES:
            for retention in (1.0, 0.6, 0.3):
                for variant in (None, "windowed"):
                    t = TD.prepare_config(arch, shape, retention=retention, variant=variant)
                    j = JD.prepare_config(arch, shape, retention=retention, variant=variant)
                    assert dataclasses.asdict(t) == dataclasses.asdict(j), (arch, shape, retention)
                    assert TD.long_500k_eligible(t, variant) == JD.long_500k_eligible(j, variant)
                    n += 1
    assert n == len(list_archs()) * len(SHAPES) * 6
    # the keyword arguments reach the config as in the reference
    kw = dict(dtype="float32", scan_layers=False, remat=False, q_block=None, num_layers=3,
              seq_shard=True)
    assert dataclasses.asdict(TD.prepare_config("whisper-small", "decode_32k", **kw)) == \
        dataclasses.asdict(JD.prepare_config("whisper-small", "decode_32k", **kw))


def _dtype_name(t):
    return str(t.dtype).replace("torch.", "")


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "whisper-small", "internvl2-76b",
                                  "recurrentgemma-9b", "xlstm-1.3b"])
def test_input_specs_equal_the_reference(arch, eight_devices):
    mesh = jax.make_mesh((2, 4), ("data", "model"), devices=eight_devices)
    fake = FakeMesh(data=2, model=4)
    tc = t_configs.smoke_config(arch).replace(dtype="bfloat16")
    jc = j_smoke_config(arch).replace(dtype="bfloat16")
    for shape, shp in SHAPES.items():
        ref = JD.input_specs(jc, shape, mesh)
        port = TD.input_specs(tc, shape, fake)
        if shp.kind in ("train", "prefill"):
            pairs = [(k, port["batch"][k], port["pspecs"]["batch"][k], v)
                     for k, v in ref["batch"].items()]
            assert set(port["batch"]) == set(ref["batch"])
        else:
            pairs = [(p, t, s, r) for (p, t, r), (_, s, _) in zip(
                _leaves(port["state"]["caches"], ref["state"]["caches"]),
                _leaves(port["pspecs"]["state"], ref["state"]["caches"]))]
            pairs.append(("token", port["token"], port["pspecs"]["token"], ref["token"]))
        for path, t, spec, r in pairs:
            assert t.device.type == "meta", path
            assert tuple(t.shape) == tuple(r.shape), (shape, path)
            assert _dtype_name(t) == r.dtype.name, (shape, path)
            assert spec == tuple(r.sharding.spec), (shape, path, spec, r.sharding.spec)
            assert TD.block_shape(t.shape, spec, fake) == r.sharding.shard_shape(r.shape), path


# ---------------------------------------------------------------------------
# make_step against the reference's steps
# ---------------------------------------------------------------------------

# microbatch 1 and 2, float32 and bf16 AdamW state (whisper's step, its
# encoder and cross attention included, is tests/test_torch_train.py's)
TRAIN_CASES = [
    ("internlm2-1.8b", 2, "float32"),
    ("recurrentgemma-9b", 1, "bfloat16"),
    ("granite-moe-1b-a400m", 2, "bfloat16"),
]


def _smoke_batch(tc, rng, b, s):
    batch = {"tokens": rng.integers(0, tc.vocab_size, size=(b, s)).astype(np.int32)}
    if tc.encoder_layers:
        batch["enc_embeds"] = (0.5 * rng.standard_normal((b, 16, tc.d_model))).astype(np.float32)
    return batch


def _init(arch, seed):
    tc, jc = t_configs.smoke_config(arch), j_smoke_config(arch)
    from repro_torch.models import transformer as TT

    tp = TT.init_params(torch.Generator().manual_seed(seed), tc)
    # copies: the port's train step updates ``tp`` in place, and a JAX array
    # made by ``asarray`` may share the numpy view's memory
    return tc, jc, tp, jax.tree.map(jnp.array, tree_to_numpy(tp))


@pytest.mark.parametrize("arch,microbatch,opt_dtype", TRAIN_CASES)
def test_make_step_train_matches_the_reference(arch, microbatch, opt_dtype):
    tc, jc, tp, jp = _init(arch, 5)
    batch = _smoke_batch(tc, np.random.default_rng(9), 4, 16)
    j_step, _ = JD.make_step(jc, "train_4k", opt_dtype=opt_dtype, microbatch=microbatch)
    j_state = j_opt.adamw(LR, state_dtype=jnp.dtype(opt_dtype)).init(jp)
    jp2, js2, j_loss = jax.block_until_ready(
        jax.jit(j_step)(jp, j_state, {k: jnp.asarray(v) for k, v in batch.items()}))
    t_step, _ = TD.make_step(tc, "train_4k", opt_dtype=opt_dtype, microbatch=microbatch)
    t_state = t_opt.adamw(LR, state_dtype=getattr(torch, opt_dtype)).init(tp)
    tp2, ts2, t_loss = t_step(tp, t_state, {k: torch.as_tensor(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(t_loss), float(j_loss), rtol=LOSS_TOL)
    assert int(ts2["t"]) == int(js2["t"]) == 1
    bf16 = opt_dtype == "bfloat16"
    for key, tol in (("m", GRAD_TOL), ("v", 2 * GRAD_TOL)):
        for path, t, r in _leaves(ts2[key], js2[key]):
            assert (_dtype_name(t), tuple(t.shape)) == (r.dtype.name, r.shape), (key, path)
            t, r = t.float().numpy(), np.asarray(r, np.float32)
            bound = tol * float(np.abs(r).max()) + (BF16_ROUND * np.abs(r) if bf16 else 0.0)
            assert np.all(np.abs(t - r) <= bound), (key, path)
    # a bf16 state moves the first update (about lr * m / sqrt(v)) by its
    # rounding: one bf16 ulp of m (2**-7) and half of one of v, at most
    apart = 1e-6 + (2 * BF16_ROUND * LR if bf16 else 0.0)
    far = total = 0
    for path, t, r in _leaves(tree_to_numpy(tp2), _np(jp2)):
        d = np.abs(t - np.asarray(r))
        assert float(d.max()) <= 2 * LR, path
        far += int((d > apart).sum())
        total += d.size
    assert far <= FLIP_SHARE * total


# the two archs whose decode state is more than a ring of K/V: recurrent
# states and windowed rings, and the encoder's cross K/V (the plain rings of
# internlm2 and granite are held by tests/test_torch_llm_serve.py and
# tests/test_torch_moe.py through the same prefill and decode_step)
@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "whisper-small"])
def test_make_step_prefill_and_decode_match_the_reference(arch):
    tc, jc, tp, jp = _init(arch, 6)
    rng = np.random.default_rng(10)
    batch = _smoke_batch(tc, rng, 2, 40)
    token = rng.integers(0, tc.vocab_size, size=(2,)).astype(np.int32)
    jpre, _ = JD.make_step(jc, "prefill_32k")
    jdec, _ = JD.make_step(jc, "decode_32k")
    tpre, _ = TD.make_step(tc, "prefill_32k")
    tdec, _ = TD.make_step(tc, "decode_32k")
    j_logits, j_state = jax.jit(jpre)(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    t_logits, t_state = tpre(tp, {k: torch.as_tensor(v) for k, v in batch.items()})
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits), atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)
    assert t_state["pos"] == int(j_state["pos"]) == 40
    for path, t, r in _leaves(t_state["caches"], j_state["caches"]):
        torch.testing.assert_close(t, torch.as_tensor(np.array(r)), atol=CACHE_TOL,
                                   rtol=CACHE_TOL, msg=path)
    j_logits, _ = jax.jit(jdec)(jp, j_state, jnp.asarray(token))
    t_logits, t_state = tdec(tp, t_state, torch.as_tensor(token))
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits), atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)
    assert t_state["pos"] == 41


# ---------------------------------------------------------------------------
# the count
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,microbatch", [("internlm2-1.8b", 2), ("recurrentgemma-9b", 1)])
def test_meta_count_equals_the_cpu_count(arch, microbatch):
    cfg = t_configs.smoke_config(arch)
    step, abstract_args = TD.make_step(cfg, "train_4k", microbatch=microbatch)
    on_cpu = TD.count_step(step, abstract_args(device="cpu", batch=4, seq=16))
    args = abstract_args(device="meta", batch=4, seq=16)
    assert all(t.device.type == "meta" for t in t_opt.tree_leaves(args[0]))
    on_meta = TD.count_step(step, args)
    assert on_meta.product_flops == on_cpu.product_flops > 0
    if arch == "internlm2-1.8b":   # no scan: the same pointwise work and traffic
        assert (on_meta.flops, on_meta.bytes) == (on_cpu.flops, on_cpu.bytes)
    assert on_meta.peak_live_bytes > 0 and on_meta.saved_bytes > 0


@pytest.mark.parametrize("arch,shape", [("internlm2-1.8b", "train_4k"),
                                        ("recurrentgemma-9b", "prefill_32k")])
def test_count_is_outer_plus_k_periods(arch, shape):
    """Every layer is counted unrolled, so the count at ``k`` pattern
    periods is ``outer + k * per_period`` exactly (what the reference
    extrapolates from 1 and 2 periods)."""
    mesh = FakeMesh(data=16, model=16)
    period = len(TD.prepare_config(arch, shape).block_pattern)
    counts = [TD.count_pair(TD.prepare_config(arch, shape, num_layers=k * period), shape, mesh)[0]
              for k in (1, 2, 3)]
    for field in ("flops", "bytes", "ops"):
        c1, c2, c3 = (getattr(c, field) for c in counts)
        per, outer = c2 - c1, 2 * c1 - c2
        assert per > 0 and outer > 0 and c3 == outer + 3 * per, field
    full = TD.prepare_config(arch, shape)
    shp = SHAPES[shape]
    tokens = shp.global_batch * shp.seq_len
    model = flops_per_token(full, shp.seq_len) * tokens / (1 if shp.kind == "train" else 3)
    per = counts[1].flops - counts[0].flops
    counted = 2 * counts[0].flops - counts[1].flops + full.num_layers / period * per
    assert model / counted <= 1.0


def _reference_keys(path, func, var):
    """The keys of the dict literal that ``func`` in the reference file
    ``path`` returns (or assigns to ``var``)."""
    tree = ast.parse((ROOT / path).read_text())
    fn = next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef) and n.name == func)
    for node in ast.walk(fn):
        if var is None and isinstance(node, ast.Return) and isinstance(node.value, ast.Dict) \
                and len(node.value.keys) > 10:
            return {k.value for k in node.value.keys}
        if var is not None and isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict) \
                and any(getattr(t, "id", None) == var for t in node.targets):
            return {k.value for k in node.value.keys}
    raise AssertionError(f"no dict in {func}")


def test_records_carry_the_reference_keys_and_roofline_table_prints_the_reference_lines(
        tmp_path, capsys, monkeypatch):
    sys.path.insert(0, str(ROOT))
    from benchmarks import run as jrun

    out = tmp_path / "results" / "roofline_single.jsonl"
    out.parent.mkdir()
    TR.main(["--arch", "xlstm-1.3b", "--shape", "long_500k", "--out", str(out)])
    TR.main(["--arch", "qwen3-32b", "--shape", "long_500k", "--out", str(out)])
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    assert [r["status"] for r in recs] == ["ok", "skipped"]
    ok = recs[0]
    assert _reference_keys("src/repro/launch/roofline.py", "analyze_pair", None) <= set(ok)
    assert 0 < ok["useful_flops_ratio"] <= 1.0
    assert ok["hardware"] == "NVIDIA H100 80GB HBM3" and "NVLink" in ok["collective_link"]
    assert ok["t_compute_s"] == ok["flops_per_device"] / 989e12
    # a failed record prints as the reference prints it too
    with open(out, "a") as f:
        f.write(json.dumps({"arch": "a", "shape": "b", "status": "FAILED", "error": "x"}) + "\n")
    capsys.readouterr()
    jrun.roofline_table(str(out))
    ref = capsys.readouterr().out
    trun.roofline_table(str(out))
    assert capsys.readouterr().out == ref and ref.count("\n") == 3
    monkeypatch.chdir(tmp_path)
    assert trun.main(["--only", "roofline_table", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "name,value,derived" and lines[1:-1] == ref.splitlines()
    assert lines[-1].startswith("roofline_table/_elapsed_s,")
    # the dry-run's record of the same pair: the reference's keys, and the
    # argument bytes of every leaf's block under the rules
    rec = TD.run_pair("xlstm-1.3b", "long_500k", "single", verbose=False)
    assert _reference_keys("src/repro/launch/dryrun.py", "run_pair", "rec") <= set(rec)
    assert set(rec["memory"]) >= {"argument_bytes", "output_bytes", "temp_bytes", "peak_bytes"}
    assert set(rec["collectives"]) >= {"all-reduce", "all-gather", "reduce-scatter",
                                       "all-to-all", "collective-permute", "count", "total"}
    assert rec["params"] == JD.param_count(JD.prepare_config("xlstm-1.3b", "long_500k")) == \
        param_count(TD.prepare_config("xlstm-1.3b", "long_500k"))
    assert rec["memory"]["argument_bytes"] == ok["arg_bytes"] > 0


def test_hillclimb_pairs_equal_the_reference():
    tree = ast.parse((ROOT / "benchmarks" / "hillclimb.py").read_text())
    node = next(n for n in tree.body if isinstance(n, ast.Assign)
                and getattr(n.targets[0], "id", None) == "PAIRS")
    scope = {}
    exec(compile(ast.Module(body=[node], type_ignores=[]), "hillclimb", "exec"), {}, scope)
    assert thc.PAIRS == scope["PAIRS"]
    assert sum(len(v) for v in thc.PAIRS.values()) == 12


# ---------------------------------------------------------------------------
# the wrappers' meta route
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_wrappers_take_meta_tensors_forward_and_backward(dtype):
    b, s, h, kv, d = 2, 48, 4, 2, 64
    q = torch.empty(b, s, h, d, dtype=dtype, device="meta", requires_grad=True)
    k = torch.empty(b, s, kv, d, dtype=dtype, device="meta", requires_grad=True)
    v = torch.empty(b, s, kv, d, dtype=dtype, device="meta", requires_grad=True)
    before = (dict(fa_mod.LAUNCHES), dict(fa_mod.BWD_LAUNCHES), dict(rg_mod.LAUNCHES),
              dict(rg_mod.BWD_LAUNCHES), dict(pm_mod.LAUNCHES))
    with FlopCounterMode(display=False) as fc:
        o = fa_mod.flash_attention(q, k, v, window=16)
        dq, dk, dv = torch.autograd.grad(o, (q, k, v), torch.empty_like(o))
    assert (o.device.type, o.dtype, tuple(o.shape)) == ("meta", dtype, (b, s, h, d))
    for g, x in ((dq, q), (dk, k), (dv, v)):
        assert (g.device.type, g.dtype, g.shape) == ("meta", dtype, x.shape)
    # the plain forward's two products and the backward's five, dense
    assert fc.get_total_flops() == 7 * 2 * b * h * s * s * d
    x = torch.empty(b, s, 32, dtype=dtype, device="meta", requires_grad=True)
    a = torch.empty(b, s, 32, dtype=dtype, device="meta", requires_grad=True)
    h0 = torch.empty(b, 32, device="meta", requires_grad=True)
    y = rg_mod.rg_lru_scan(x, a, h0)
    dx, da, dh0 = torch.autograd.grad(y, (x, a, h0), torch.empty_like(y))
    assert (y.device.type, y.dtype, y.shape) == ("meta", dtype, x.shape)
    assert (dx.dtype, da.dtype, dh0.dtype, dh0.shape) == (dtype, dtype, torch.float32, h0.shape)
    w = torch.empty(3, 40, 24, dtype=dtype, device="meta", requires_grad=True)
    xm = torch.empty(3, 10, 40, dtype=dtype, device="meta", requires_grad=True)
    masks = [torch.ones(40, device="meta"), torch.ones(24, device="meta")]
    ym = pm_mod.pruned_matmul(xm, w, *masks)
    gx, gw = torch.autograd.grad(ym, (xm, w), torch.empty_like(ym))
    assert (ym.device.type, ym.dtype, ym.shape, gx.shape, gw.shape) == (
        "meta", dtype, (3, 10, 24), xm.shape, w.shape)
    assert before == (dict(fa_mod.LAUNCHES), dict(fa_mod.BWD_LAUNCHES), dict(rg_mod.LAUNCHES),
                      dict(rg_mod.BWD_LAUNCHES), dict(pm_mod.LAUNCHES))
    # on the CPU the bf16 backwards still refuse
    if dtype == torch.bfloat16:
        qc = torch.zeros(1, 4, 2, 64, dtype=dtype, requires_grad=True)
        with pytest.raises(NotImplementedError, match="queue B"):
            fa_mod.flash_attention(qc, qc, qc).sum().backward()
