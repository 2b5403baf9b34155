"""The port's kernel labs and HBM yardstick (``nwhead_tpu_torch/labs/``)
against the JAX package's ``bench.py`` and ``scripts/`` labs.

The same seeded numpy inputs go through the JAX lab function and the
port's counterpart on the CPU, where the port runs its plain versions and
the Pallas kernels run in interpret mode: ``stream_reduce``,
``fused_variant`` and ``bench._stream_case`` through ``pl.pallas_call``
wrapped to pass ``interpret=True`` (they take no ``interpret`` argument),
``manual_fused`` and ``fused_blocks`` through their own ``interpret=True``.
``bench.py`` and ``scripts/`` are imported by path, inside the tests: the
card's machine has no jax.

Tolerances: the stream sums within rtol 1e-5 of the sum of |x| they add;
``fused_variant`` and ``manual_fused`` log-probs within 2e-5 (bf16 casts
and banks: 1e-4 and 2e-3), the same f32 sums in another order;
``fused_blocks`` within 1e-2 of max|JAX output|, since a bf16
intermediate may round one ulp apart where the f32 sums' order differs.

The CUDA kernels are held to their plain versions on the card only (marker
``gpu``): ``python -m pytest --noconftest -m gpu tests/test_torch_labs.py``.
"""

import contextlib
import importlib.util
import os
import runpy
import sys

import numpy as np
import pytest
import torch

from nwhead_tpu_torch import labs
from nwhead_tpu_torch.labs import block_lab, kernel_lab, manual_pipe_lab
from nwhead_tpu_torch.labs import stream as lab_stream
from nwhead_tpu_torch.ops import fused_nw as F
from nwhead_tpu_torch.ops.fused_nw import prepare_support

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LABS = ("kernel_lab", "manual_pipe_lab", "prepared_lab", "roofline_lab", "block_lab",
        "mlp_block_lab", "attn_block_lab", "prepared_head_lab", "raw_head_lab")


def _script(relpath: str):
    """Import ``bench.py`` or a ``scripts/`` lab by path; ``sys.path`` as it
    was afterwards (the labs insert the repository and ``scripts/``)."""
    saved = list(sys.path)
    sys.path[:0] = [REPO, os.path.join(REPO, "scripts")]
    try:
        name = "_jax_lab_" + os.path.basename(relpath)[:-3]
        spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, relpath))
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module
    finally:
        sys.path[:] = saved


@pytest.fixture
def interpret(monkeypatch):
    """``pl.pallas_call`` passing ``interpret=True``, for the lab kernels
    that take no ``interpret`` argument."""
    from jax.experimental import pallas as pl

    real = pl.pallas_call

    def call(*args, **kwargs):
        kwargs["interpret"] = True
        return real(*args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", call)


def _np(x):
    return np.asarray(x, dtype=np.float32)


def _nw_inputs(seed=0, B=5, S=1100, D=40, C=7, masked=0.1):
    """Raw NW lab inputs with a ragged S and masked rows (label -1)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, D)).astype(np.float32)
    s = rng.standard_normal((S, D)).astype(np.float32)
    sy = rng.integers(0, C, size=S).astype(np.int32)
    sy[rng.random(S) < masked] = -1
    return q, s, sy, C


# --- K13 / L4 stream and L1 stream_reduce --------------------------------


@pytest.mark.parametrize("where", ["bench", "roofline_lab"])
def test_stream_matches_the_jax_yardstick(interpret, where):
    """``stream_case`` draws the bench's bank from the same generator, and
    ``stream(s).mean()`` is the JAX kernel's mean."""
    if where == "bench":
        (_, fn, args), nbytes = _script("bench.py")._stream_case(np.random.default_rng(3),
                                                                 D=128, rows=4096)
    else:
        (_, fn, args), nbytes = _script("scripts/roofline_lab.py").stream_case(
            np.random.default_rng(3), 4096, 128)
    want = float(fn(*args, 0.0))
    (name, port_fn, (s,)), port_bytes = lab_stream.stream_case(np.random.default_rng(3), D=128,
                                                               rows=4096, device="cpu")
    assert name == "stream" and port_bytes == nbytes == 4096 * 128 * 4
    np.testing.assert_array_equal(s.numpy(), _np(args[0]))
    got = float(port_fn(s))
    assert got == pytest.approx(float(lab_stream.stream(s).mean()))
    assert got == pytest.approx(want, rel=1e-5)


@pytest.mark.parametrize("touch_only", [False, True])
@pytest.mark.parametrize("block_s", [512, 1024])
def test_stream_reduce_matches_kernel_lab(interpret, block_s, touch_only):
    import jax.numpy as jnp

    lab = _script("scripts/kernel_lab.py")
    x = np.random.default_rng(1).standard_normal((3 * block_s + 40, 128)).astype(np.float32)
    want = _np(lab.stream_reduce(jnp.asarray(x), block_s, touch_only))
    got = lab_stream.stream_reduce(torch.from_numpy(x), block_s, touch_only).numpy()
    assert got.shape == want.shape == ((8 if touch_only else 1), 128)
    tiles = np.abs(x[:3 * block_s]).reshape(3, block_s, 128)
    scale = tiles[:, :8].sum(0) if touch_only else tiles.sum((0, 1))[None]
    assert np.all(np.abs(got - want) <= 1e-5 * scale)


def test_stream_refuses_what_it_cannot_read():
    s = torch.zeros(100, 64)
    with pytest.raises(ValueError, match="whole tile"):
        lab_stream.stream_reduce(s, 128)
    with pytest.raises(ValueError, match="CUDA"):
        lab_stream.stream_cuda(torch.zeros(2048, 64))
    with pytest.raises(ValueError, match="CUDA"):
        lab_stream.stream_reduce_cuda(torch.zeros(2048, 64), 1024, True)
    with pytest.raises(ValueError, match="multiple of 8"):
        lab_stream._chunk_rows(1001, 64, 32768)
    assert lab_stream._chunk_rows(2048, 512, 32768) == 8
    assert lab_stream._chunk_rows(2048, 128, 32768) == 32
    assert lab_stream._chunks_per_block(96, 256, 132) == 32  # 768 blocks over 132 SMs


@pytest.mark.parametrize("touch_only", [False, True])
def test_plain_agreement_flags_a_wrong_sum(touch_only):
    s = torch.from_numpy(np.random.default_rng(4).standard_normal((1024, 64)).astype(np.float32))
    want = lab_stream._stream_reduce_plain(s, 256, touch_only)
    assert lab_stream.plain_agreement(want.clone(), s, 256, touch_only) == (True, 0.0)
    off = want.clone()
    off[0, 3] += 1e-2  # one tile's row missed is far more than this
    ok, err = lab_stream.plain_agreement(off, s, 256, touch_only)
    assert not ok and err == pytest.approx(1e-2, rel=1e-3)
    off[0, 3] = float("nan")
    assert not lab_stream.plain_agreement(off, s, 256, touch_only)[0]


@pytest.mark.parametrize("kernel", sorted(labs.LAB_KERNELS))
def test_lab_wrapper_is_the_counted_kernel_wrapper(kernel):
    from nwhead_tpu_torch.ops import _cuda

    w = labs.lab_wrapper(kernel)
    assert w.__name__.endswith("_cuda") and isinstance(w.launches, int)
    assert labs.LAB_KERNELS[kernel] in {src.stem for src in _cuda.sources()}


# --- L1 fused_variant --------------------------------------------------------


@pytest.mark.parametrize("cast", ["f32", "bf16"])
@pytest.mark.parametrize("agg", ["f32", "split"])
@pytest.mark.parametrize("dist", ["f32", "f32s2", "x3"])
def test_fused_variant_matches_kernel_lab(interpret, dist, agg, cast):
    """Every distance and aggregation option, both casts, at ``block_s``
    512 over a ragged bank with masked rows; the TPU label layout (``wide``
    or ``compact``) alternates and changes nothing in the port."""
    import jax.numpy as jnp

    lab = _script("scripts/kernel_lab.py")
    q, s, sy, C = _nw_inputs()
    labels = "wide" if (dist, agg) in (("f32", "f32"), ("x3", "split"), ("f32s2", "f32")) \
        else "compact"
    opts = dict(labels=labels, dist=dist, agg=agg, block_s=512, cast=cast)
    want = _np(lab.fused_variant(jnp.asarray(q), jnp.asarray(s), jnp.asarray(sy), C, **opts))
    got = kernel_lab.fused_variant(torch.from_numpy(q), torch.from_numpy(s), torch.from_numpy(sy),
                                   C, **opts).numpy()
    tol = 1e-4 if cast == "bf16" else 2e-5
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


@pytest.mark.parametrize("probe", [dict(labels="none"), dict(dist="skip"), dict(agg="skip")])
def test_fused_variant_refuses_the_timing_probes(probe):
    q, s, sy, C = _nw_inputs(B=2, S=64, D=8)
    with pytest.raises(ValueError, match="timing probe"):
        kernel_lab.fused_variant(torch.from_numpy(q), torch.from_numpy(s), torch.from_numpy(sy),
                                 C, **probe)


def test_fused_variant_inputs_and_refusals():
    """The x3 operands split the bank as the TPU lab does; the kernel
    wrapper refuses CPU tensors; ``mm_prec``/``agg_prec`` change nothing."""
    q, s, sy, C = _nw_inputs(B=3, S=200, D=16)
    qt, st = torch.from_numpy(q), torch.from_numpy(s)
    x = kernel_lab.variant_inputs(qt, st, "x3")
    assert x.s.dtype == x.s_lo.dtype == torch.bfloat16 and x.q.dtype == torch.float32
    torch.testing.assert_close(x.s.float() + x.s_lo.float(), st, rtol=0, atol=1e-4)
    torch.testing.assert_close(x.s2, (st * st).sum(1))
    assert x.cast == "f32" and kernel_lab.variant_inputs(qt.bfloat16(), st.bfloat16(),
                                                         "f32").cast == "bf16"
    with pytest.raises(ValueError, match="CUDA"):
        kernel_lab.fused_variant_cuda(x, torch.from_numpy(sy), C, "x3", "f32", 512)
    base = kernel_lab.fused_variant(qt, st, sy, C)
    hi = kernel_lab.fused_variant(qt, st, sy, C, mm_prec="highest", agg_prec="high")
    torch.testing.assert_close(base, hi, rtol=0, atol=0)
    with pytest.raises(ValueError, match="mm_prec"):
        kernel_lab.fused_variant(qt, st, sy, C, mm_prec="fastest")


# The fused_variant kernel runs on the forward's tensor-core pass 1: its
# block_s and block_b map onto that pass's split length and query tile.


@pytest.mark.parametrize("block_s,rows,n_splits", [(2048, 2048, 3), (512, 512, 12),
                                                   (100, 128, 47), (1, 64, 94)])
def test_variant_plan_maps_block_s_to_whole_tiles(block_s, rows, n_splits):
    assert kernel_lab.variant_plan(64, 5994, 200, block_s) == (32, rows, n_splits)


@pytest.mark.parametrize("block_b,C,qb", [(None, 200, 32), (8, 200, 8), (16, 200, 16),
                                          (20, 200, 32), (64, 200, 32), (None, 1000, 32),
                                          (None, 4000, 8), (5, 7, 8)])
def test_variant_plan_rounds_block_b_to_the_query_tile(block_b, C, qb):
    """The query tile follows block_b (the batch without it), rounded up
    to 8, 16 or 32 and cut to what the classes' accumulator leaves room
    for, as K1's and K2's."""
    assert kernel_lab.variant_plan(64, 5994, C, 2048, block_b)[0] == qb
    if block_b is None:
        assert qb == F._tc_query_tile(64, C, False, F.H100_SMEM_OPTIN)


def test_variant_plan_refuses_too_many_classes():
    with pytest.raises(ValueError, match="n_classes"):
        kernel_lab.variant_plan(64, 5994, 6000, 2048)


@pytest.mark.parametrize("B,S,C,block_s", [(64, 5994, 200, 128), (8, 1200, 200, 64),
                                           (64, 65536, 1000, 1024)])
def test_k1_block_s_gives_k1_split_count(B, S, C, block_s):
    """At the CUB shape K1 runs 47 splits of 128 rows on an H100's 132
    SMs; the lab's block_s of that split length gives the same grid."""
    assert kernel_lab.k1_block_s(B, S, C, 132) == block_s
    qb, rows, n_splits = kernel_lab.variant_plan(B, S, C, block_s)
    assert (rows, n_splits) == F._tc_splits(S, -(-B // qb), 132)


def test_x3_dot_sums_in_the_kernel_order():
    """``_x3_dot`` is ``qh.sh + (ql.sh + qh.sl)``, the kernel's order, bit
    for bit, each term of the split in bf16; it stays within f32 rounding
    of the f64 product of the split operands."""
    rng = np.random.default_rng(11)
    q = torch.from_numpy(rng.standard_normal((9, 96)).astype(np.float32))
    s = torch.from_numpy(rng.standard_normal((70, 96)).astype(np.float32))
    got = kernel_lab._x3_dot(q, s)
    qh, ql = kernel_lab._bf16_split(q)
    sh, sl = kernel_lab._bf16_split(s)
    for x in (qh, ql, sh, sl):
        torch.testing.assert_close(x, x.bfloat16().float(), rtol=0, atol=0)
    torch.testing.assert_close(got, qh @ sh.T + (ql @ sh.T + qh @ sl.T), rtol=0, atol=0)
    want = (qh.double() @ sh.double().T + ql.double() @ sh.double().T
            + qh.double() @ sl.double().T)
    torch.testing.assert_close(got.double(), want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("agg", ["f32", "split"])
def test_fused_variant_x3_order_matches_kernel_lab(interpret, agg):
    """x3 in the kernel's order of the three sums against the JAX lab's
    variant in interpret mode, at ``kernel_lab --tiny``'s shape with masked
    rows and at the lab's block_s 2,048 (one block over the whole bank)."""
    import jax.numpy as jnp

    lab = _script("scripts/kernel_lab.py")
    q, s, sy, C = _nw_inputs(seed=3, B=8, S=700, D=64, C=12)
    opts = dict(labels="compact", dist="x3", agg=agg, block_s=2048)
    want = _np(lab.fused_variant(jnp.asarray(q), jnp.asarray(s), jnp.asarray(sy), C, **opts))
    got = kernel_lab.fused_variant(torch.from_numpy(q), torch.from_numpy(s), torch.from_numpy(sy),
                                   C, **opts).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)


# --- L3 manual_fused ---------------------------------------------------------


@pytest.mark.parametrize("block_s", [512, 1024])
@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_manual_fused_matches_manual_pipe_lab(precision, block_s):
    import jax.numpy as jnp

    from nwhead_tpu.ops import pallas_nw

    lab = _script("scripts/manual_pipe_lab.py")
    q, s, sy, C = _nw_inputs(seed=2, B=6, S=1500, D=64, C=9, masked=0.0)
    jprep = pallas_nw.prepare_support(jnp.asarray(s), jnp.asarray(sy), C, block_s=block_s,
                                      precision=precision)
    # The lab unpacks four fields (s, s2, lane labels, sublane labels); the
    # JAX PreparedSupport has grown to six since, and the lab is kept as it
    # was, so it is handed the first four.
    want = _np(lab.manual_fused(jnp.asarray(q), tuple(jprep[:4]), C, interpret=True))
    prep = prepare_support(torch.from_numpy(s), sy, C, precision=precision, block_s=block_s)
    got = manual_pipe_lab.manual_fused(torch.from_numpy(q), prep, C).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5 if precision == "f32" else 2e-3)


def test_manual_fused_refuses_untiled_banks_and_cpu_launches():
    q, s, sy, C = _nw_inputs(B=2, S=300, D=16, masked=0.0)
    with pytest.raises(ValueError, match="block_s"):
        manual_pipe_lab.manual_fused(torch.from_numpy(q), prepare_support(torch.from_numpy(s),
                                                                           sy, C), C)
    prep = prepare_support(torch.from_numpy(s), sy, C, block_s=128)
    with pytest.raises(ValueError, match="CUDA"):
        manual_pipe_lab.manual_fused_cuda(torch.from_numpy(q), prep, C)


# manual_fused runs K2's route of the tensor-core pass 1 over one block_s
# tile a split, with the rings' depth as its variable: its launch plan and
# shared memory are pure functions of the shapes.


@pytest.mark.parametrize("S,block_s,n_splits", [
    (1500, 512, 3), (1500, 1024, 2), (1500, 2048, 1),
    (5994, 512, 12), (5994, 1024, 6), (5994, 2048, 3)])
def test_manual_plan_splits_whole_tiles(S, block_s, n_splits):
    """One split a prepared ``block_s`` tile, ``ceil(S_pad / block_s)``
    of them, each whole 64-row tiles (``prepare_support`` rounds
    ``block_s`` to 128 and cuts it to the padded bank); the query tiles
    are the pass's own: 2 of 32 at B=64 (12 blocks at block_s 1,024), 1 of
    8 at B=8."""
    rng = np.random.default_rng(4)
    prep = prepare_support(torch.from_numpy(rng.standard_normal((S, 8)).astype(np.float32)),
                           rng.integers(0, 200, size=S).astype(np.int32), 200, block_s=block_s)
    S_pad = prep.s.shape[0]
    for B, qb in ((64, 32), (8, 8)):
        got = manual_pipe_lab.manual_plan(B, S_pad, prep.block_s, 200, 3)
        assert got[:3] == (qb, prep.block_s, n_splits)
        assert n_splits == -(-S_pad // prep.block_s) and prep.block_s % 64 == 0
        assert S_pad == n_splits * prep.block_s
    # Any split length is rounded up to whole tiles; K2's own at B=64 is 128.
    assert manual_pipe_lab.manual_plan(64, 6144, 100, 200, 3)[1:3] == (128, 48)
    assert manual_pipe_lab.manual_plan(64, 6144, 128, 200, 3)[1:3] == F._tc_splits(6144, 2, 132)


@pytest.mark.parametrize("B,C", [(64, 200), (16, 200), (8, 200), (5, 9), (64, 1000)])
def test_manual_plan_smem_matches_tc_smem_bytes(B, C):
    """At 3 stages the block is K2's (``_tc_smem_bytes``); each stage more
    adds one slice to each group's ring and its two barriers. At the CUB
    shape's 32-query tile and C = 200 the deepest ring, 7 stages, takes
    231,008 of the 232,448 bytes."""
    plan = manual_pipe_lab.manual_plan
    fits = [st for st in manual_pipe_lab.MANUAL_STAGES
            if F._tc_smem_bytes(F._tc_query_tile(B, C, False, F.H100_SMEM_OPTIN), C, False,
                                st) <= F.H100_SMEM_OPTIN]
    qb, _, _, smem3 = plan(B, 6144, 1024, C, 3)
    assert smem3 == F._tc_smem_bytes(qb, C, False)
    assert F._tc_stage_bytes(qb) == {32: 13312, 16: 11264, 8: 11264}[qb]
    for st in fits:
        assert plan(B, 6144, 1024, C, st)[3] == smem3 + (st - 3) * (2 * F._tc_stage_bytes(qb) + 32)
    if (B, C) == (64, 200):
        assert fits == list(manual_pipe_lab.MANUAL_STAGES)
        assert plan(B, 6144, 1024, C, 7)[3] == 231008


def test_manual_plan_refuses_a_ring_that_does_not_fit():
    plan = manual_pipe_lab.manual_plan
    for stages in (8, 5, 1, 0):  # not built, and 8 would not fit at qb = 32, C = 200
        with pytest.raises(ValueError, match="built for"):
            plan(64, 6144, 1024, 200, stages)
    assert F._tc_smem_bytes(32, 200, False, 8) > F.H100_SMEM_OPTIN
    with pytest.raises(ValueError, match="shared memory"):
        plan(64, 6144, 1024, 300, 7)  # 243,808 bytes
    assert plan(8, 6144, 1024, 300, 7)[0] == 8  # the 8-query tile's block fits
    with pytest.raises(ValueError, match="shared memory"):
        plan(64, 6144, 1024, 200, 7, smem_optin=231007)


def test_manual_stages_are_the_library_build():
    """``MANUAL_STAGES`` names the depths ``csrc/lab_nw.cu`` instantiates,
    each a case of its ``manual_forward``."""
    src = open(os.path.join(REPO, "nwhead_tpu_torch", "csrc", "lab_nw.cu")).read()
    built = src.split("constexpr int kManualStages[] = {")[1].split("}")[0]
    assert tuple(int(x) for x in built.split(",")) == manual_pipe_lab.MANUAL_STAGES
    for st in manual_pipe_lab.MANUAL_STAGES:
        assert f"case {st}: return manual_at<T, {st}>" in src


def test_manual_fused_plain_ignores_stages():
    """On the CPU every depth takes the plain version: the same bits."""
    q, s, sy, C = _nw_inputs(seed=5, B=6, S=700, D=24, C=9)
    for precision in ("f32", "bf16"):
        prep = prepare_support(torch.from_numpy(s), np.maximum(sy, 0), C, precision=precision,
                               block_s=256)
        outs = [manual_pipe_lab.manual_fused(torch.from_numpy(q), prep, C, st)
                for st in manual_pipe_lab.MANUAL_STAGES]
        assert all(torch.equal(o, outs[0]) for o in outs)
        torch.testing.assert_close(outs[0], manual_pipe_lab.manual_fused(torch.from_numpy(q), prep,
                                                                          C), rtol=0, atol=0)
        with pytest.raises(ValueError, match="built for"):
            manual_pipe_lab.manual_fused(torch.from_numpy(q), prep, C, 5)


# --- build_diff: two checkouts' kernels, SASS and ptxas ----------------------

_SASS = """
Fatbin elf code:
================
arch = sm_90a

	code for sm_90a
		Function : _Z1kILi3EEvv
	.headerflags	@"EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   EXIT ;
		..........

		Function : _Z1gv
        /*0000*/                   EXIT ;
"""
_PTXAS = """ptxas info    : Compiling entry function '_Z1kILi3EEvv' for 'sm_90a'
ptxas info    : Function properties for _Z1kILi3EEvv
    8 bytes stack frame, 4 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 96 registers, used 1 barriers
ptxas info    : Compiling entry function '_Z1gv' for 'sm_90a'
ptxas info    : Function properties for _Z1gv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 12 registers
"""


def test_build_diff_reads_sass_and_ptxas():
    from nwhead_tpu_torch.labs import build_diff

    sass = build_diff.sass_functions(_SASS)
    assert sorted(sass) == ["_Z1gv", "_Z1kILi3EEvv"]
    assert "LDC R1" in sass["_Z1kILi3EEvv"] and "LDC" not in sass["_Z1gv"]
    assert build_diff.ptxas_report(_PTXAS) == {"_Z1kILi3EEvv": (96, 4, 12), "_Z1gv": (12, 0, 0)}


def test_build_diff_compares_renamed_kernels():
    from nwhead_tpu_torch.labs import build_diff

    parent = {"_Z1kIvv": "a", "_Z1gv": "b", "_Z1hv": "c"}
    change = build_diff._renamed({"_Z1kILi3EEvv": "a", "_Z1gv": "x", "_Z1nv": "d"},
                                 [("ILi3EEvv", "Ivv")])
    assert build_diff.compare(parent, change) == (["_Z1kIvv"], ["_Z1gv"], ["_Z1hv"], ["_Z1nv"])


# --- L2 fused_blocks ---------------------------------------------------------


def _block_weights(rng, C, n_blocks):
    """Per conv: HWIO weights and BN scale, bias, mean, var as numpy f32."""
    convs = []
    for _ in range(2 * n_blocks):
        w = (rng.standard_normal((3, 3, C, C)) * (2.0 / (9 * C)) ** 0.5).astype(np.float32)
        bn = [rng.uniform(0.5, 1.5, C), rng.normal(0, 0.2, C), rng.normal(0, 0.2, C),
              rng.normal(0.3, 0.2, C) ** 2 + 0.5]
        convs.append((w, *[a.astype(np.float32) for a in bn]))
    return convs


@pytest.mark.parametrize("n_blocks", [1, 2])
def test_fused_blocks_matches_block_lab(n_blocks):
    """B=2, C=16 at the lab's 56 x 56: each package folds the same numpy
    weights and BN statistics with its own ``fold_bn`` and packs them."""
    import jax.numpy as jnp

    lab = _script("scripts/block_lab.py")
    rng = np.random.default_rng(4)
    C = 16
    x = rng.standard_normal((2, 56, 56, C)).astype(np.float32)
    convs = _block_weights(rng, C, n_blocks)
    jw, jb = lab.pack_weights([lab.fold_bn(*c) for c in convs])
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    want = _np(lab.fused_blocks(xj, jw, jb, n_blocks=n_blocks, interpret=True).astype(jnp.float32))
    w, b = block_lab.pack_weights([block_lab.fold_bn(*c) for c in convs])
    got = block_lab.fused_blocks(torch.from_numpy(x).to(torch.bfloat16), w, b,
                                 n_blocks=n_blocks).float().numpy()
    assert got.shape == want.shape == x.shape
    assert np.max(np.abs(got - want)) <= 1e-2 * np.max(np.abs(want))


def test_fold_flax_blocks_packs_the_block_lab_weights():
    """``fold_flax_blocks`` on flax ``BasicBlock.init`` variables (batch
    statistics drawn so the fold is exercised) gives the TPU lab's folded
    weights, tap by tap, and its biases."""
    import jax
    import jax.numpy as jnp

    from nwhead_tpu.models.resnet import BasicBlock

    lab = _script("scripts/block_lab.py")
    rng = np.random.default_rng(5)
    C = 16
    variables = []
    for i in range(2):
        v = BasicBlock(planes=C, dtype=jnp.bfloat16).init(
            jax.random.PRNGKey(i), jnp.zeros((1, 8, 8, C)), train=False)
        v = jax.tree_util.tree_map(np.asarray, v)
        for bn in ("bn1", "bn2"):
            v["batch_stats"][bn] = {"mean": rng.normal(0, 0.2, C).astype(np.float32),
                                    "var": (rng.normal(0.3, 0.2, C) ** 2 + 0.5).astype(np.float32)}
        variables.append(v)
    w, b = block_lab.fold_flax_blocks(variables)
    folded = [lab.fold_bn(v["params"][c]["kernel"], v["params"][n]["scale"],
                          v["params"][n]["bias"], v["batch_stats"][n]["mean"],
                          v["batch_stats"][n]["var"])
              for v in variables for c, n in (("conv1", "bn1"), ("conv2", "bn2"))]
    jw, jb = lab.pack_weights(folded)  # im2col: (2n, C_out, 9 C_in)
    jw = _np(jnp.asarray(jw, jnp.float32)).reshape(4, C, 9, C).transpose(0, 2, 3, 1)
    np.testing.assert_array_equal(w.float().numpy(), jw)
    np.testing.assert_array_equal(b.numpy(), _np(jb)[:, 0, :])


def test_fold_basic_block_folds_the_port_block():
    """The port's eval-mode BasicBlocks in f32 against the plain
    ``fused_blocks`` on their folded, bf16-packed weights (2e-2 of max, as
    the TPU lab holds its kernel to flax)."""
    rng = np.random.default_rng(6)
    blocks = block_lab.random_blocks(8, 2, rng, "cpu")
    w, b = block_lab.pack_weights([f for blk in blocks for f in block_lab.fold_basic_block(blk)])
    x = torch.from_numpy(rng.standard_normal((2, 12, 12, 8)).astype(np.float32)).to(
        torch.bfloat16)
    with torch.no_grad():
        want = block_lab.layer_reference(blocks, x.float())
    got = block_lab.fused_blocks(x, w, b)
    assert block_lab.rel_to_max(got, want) < 2e-2
    with pytest.raises(ValueError, match="pack_weights"):
        block_lab.fused_blocks(x, w[:2], b)
    with pytest.raises(ValueError, match="CUDA"):
        block_lab.fused_blocks_cuda(x, w, b)


@pytest.mark.parametrize("shape,n_blocks,tile", [
    ((64, 56, 56, 64), 2, 14), ((64, 56, 56, 8), 2, 28), ((3, 20, 13, 32), 2, 10)])
def test_block_tile_plan_fits_a_block(shape, n_blocks, tile):
    """The kernel's tile at layer1's width (14: 56 = 4 x 14), at C = 8 and
    on a ragged image: its two region buffers, a conv's nine taps of
    weights and their alignment's 1 KB within an H100 block's 227 KB."""
    B, H, W, C = shape
    plan = block_lab.tile_plan(B, H, W, C, n_blocks)
    side = tile + 4 * n_blocks
    assert plan.tile == tile
    assert plan.x_bytes == side * side * C * 2 and plan.h_bytes == (side - 2) ** 2 * C * 2
    assert plan.weight_bytes == 9 * C * C * 2
    assert plan.smem_bytes == 1024 + plan.x_bytes + plan.h_bytes + plan.weight_bytes
    assert plan.smem_bytes <= block_lab.H100_SMEM_OPTIN
    if shape == (64, 56, 56, 64):
        assert (plan.x_bytes, plan.h_bytes, plan.weight_bytes) == (61_952, 51_200, 73_728)


def test_block_tile_plan_takes_the_fewest_rounds():
    """At layer1, tile 14's m-tiles on a block's critical path times waves
    of blocks are fewer than every other tile's that fits (8: the FFMA
    kernel's, 12, 16);
    a given tile is taken as it is; what fits no block is refused."""
    plan = block_lab.tile_plan(64, 56, 56, 64, 2)
    for tile in (8, 12, 16):
        other = block_lab.tile_plan(64, 56, 56, 64, 2, tile=tile)
        assert other.tile == tile and other.cost > plan.cost
    with pytest.raises(ValueError, match="shared memory"):
        block_lab.tile_plan(64, 56, 56, 64, 2, tile=20)
    with pytest.raises(ValueError, match="shared memory"):
        block_lab.tile_plan(1, 56, 56, 64, 8)
    x = torch.zeros((1, 8, 8, 64), dtype=torch.bfloat16)
    w, b = torch.zeros((4, 9, 64, 64), dtype=torch.bfloat16), torch.zeros((4, 64))
    with pytest.raises(ValueError, match="CUDA"):
        block_lab.fused_blocks_cuda(x, w, b, tile=14)


# --- the lab CLIs -----------------------------------------------------------


# runpy warns that the module is imported already (this file imports it).
@pytest.mark.filterwarnings("ignore:.*found in sys.modules after import of package:RuntimeWarning")
@pytest.mark.parametrize("argv", [[lab] for lab in LABS] + [["kernel_lab", "--interleave"]],
                         ids=lambda a: " ".join(a))
def test_lab_cli_runs_on_the_cpu(argv, monkeypatch, capsys):
    """``python -m nwhead_tpu_torch.labs.<lab> --device cpu --tiny``, run
    in this process: parity checked, timing not measured, exit 0."""
    monkeypatch.setattr(sys, "argv", [argv[0], *argv[1:], "--device", "cpu", "--tiny"])
    with pytest.raises(SystemExit) as done:
        runpy.run_module(f"nwhead_tpu_torch.labs.{argv[0]}", run_name="__main__",
                         alter_sys=True)
    assert done.value.code == 0, capsys.readouterr()
    assert "timing not measured" in capsys.readouterr().out


@pytest.mark.parametrize("precisions", [None, "int8,int4"])
def test_prepared_head_lab_covers_every_bank_precision(precisions, capsys):
    """``prepared_head_lab --device cpu --tiny`` holds every case of every
    bank precision asked for (all four by default) to its plain version:
    the million-row bank and its partials route, one shard, the CUB and ViT
    banks, K6 skewed, diverse and at full probe; K4 names the int8 bank's
    cases, K5 the int4 bank's."""
    import json

    from nwhead_tpu_torch.labs import prepared_head_lab

    argv = ["--device", "cpu", "--tiny"] + ([] if precisions is None else
                                            ["--precisions", precisions])
    assert prepared_head_lab.main(argv) == 0
    errs = json.loads(capsys.readouterr().out.strip().splitlines()[-1])["max_abs_err"]
    want = ("f32", "bf16", "int8", "int4") if precisions is None else ("int8", "int4")
    names = {"f32": "K2", "bf16": "K2", "int8": "K4", "int4": "K5"}
    expected = set()
    for prec in want:
        k = names[prec]
        expected |= {f"{k} {prec} million-row bank", f"{k} partials {prec} million-row bank",
                     f"{k} partials {prec} 250,000-row shard", f"{k} {prec} CUB bank",
                     f"{k} {prec} ViT bank", f"K6 {prec} skewed", f"K6 {prec} diverse",
                     f"K6 {prec} full probe"}
    assert set(errs) == expected
    assert max(errs.values()) <= 2e-3


def test_raw_head_lab_covers_k1_dq_and_the_unsorted_bank(capsys):
    """``raw_head_lab --device cpu --tiny`` holds every case to its plain
    version through the public entry points: K1, K1 ``partials`` and dq at
    the episode's, B = 64's and the streamed chunk's shapes, ds at the
    first two, K2 on the chunk's rows unsorted and sorted, f32 and bf16."""
    import json

    from nwhead_tpu_torch.labs import raw_head_lab

    assert raw_head_lab.main(["--device", "cpu", "--tiny"]) == 0
    errs = json.loads(capsys.readouterr().out.strip().splitlines()[-1])["max_abs_err"]
    expected = set()
    for prec in ("f32", "bf16"):
        for shape in ("episode", "B=64 S=5,994", "stream chunk"):
            expected |= {f"K1 {prec} {shape}", f"K1 partials {prec} {shape}",
                         f"K3 dq {prec} {shape}"}
            if shape != "stream chunk":
                expected.add(f"K3 ds {prec} {shape}")
        expected |= {f"K2 {prec} unsorted bank, stream chunk",
                     f"K2 {prec} sorted bank, stream chunk"}
    assert set(errs) == expected
    assert max(errs.values()) <= 2e-3


def test_lab_cli_without_a_card_is_an_error(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    from nwhead_tpu_torch.labs import roofline_lab

    with pytest.raises(RuntimeError, match="no CUDA device"):
        roofline_lab.main(["--tiny"])


# --- the kernels on the card -------------------------------------------------


@contextlib.contextmanager
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc to build the kernels)")
    yield torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("rows,D", [(12288, 512), (4096, 128), (6144, 384)])
def test_cuda_stream_matches_plain(rows, D):
    with _card() as dev:
        s = torch.from_numpy(np.random.default_rng(0).standard_normal((rows, D)).astype(
            np.float32)).to(dev)
        for block_s in sorted({bs for bs, _ in kernel_lab.STREAM_SETTINGS}):
            for touch in (False, True):
                got = lab_stream.stream_reduce_cuda(s, block_s, touch)
                assert lab_stream.plain_agreement(got, s, block_s, touch)[0], (block_s, touch)
        torch.testing.assert_close(lab_stream.stream_cuda(s), lab_stream._stream_plain(s),
                                   rtol=1e-5, atol=1e-4)


# Every DECOMPOSITION variant, and beside them query tiles of 32 and 8 on
# x3 with the split label sum, K1's own split length (block_s 128) on the
# bf16 raw route, and x3 on a bf16 cast (its lo half all zeros).
CUDA_VARIANTS = kernel_lab.DECOMPOSITION + (
    dict(labels="wide", dist="x3", agg="split", block_s=512, block_b=64),
    dict(labels="compact", dist="x3", agg="split", block_s=128, block_b=8),
    dict(labels="compact", dist="f32", agg="split", block_s=128, cast="bf16"),
    dict(labels="compact", dist="x3", agg="f32", block_s=1024, cast="bf16"),
)


def _cuda_variant_case(dev, variant, B, S, D, C, nan_masked=False):
    """``fused_variant`` on the card and its plain version on the same
    inputs (masked rows NaN with ``nan_masked``)."""
    q, s, sy, _ = _nw_inputs(B=B, S=S, D=D, C=C)
    if nan_masked:
        s[sy < 0] = np.nan
    qt, st = torch.from_numpy(q).to(dev), torch.from_numpy(s).to(dev)
    got = kernel_lab.fused_variant(qt, st, torch.from_numpy(sy), C, **variant)
    cast = variant.get("cast", "f32")
    qc, sc = (qt, st) if cast == "f32" else (qt.bfloat16(), st.bfloat16())
    want = kernel_lab._fused_variant_plain(qc, sc, torch.from_numpy(sy).to(dev), C,
                                           variant["dist"], variant["agg"])
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, want, rtol=0, atol=2e-4 if cast == "f32" else 2e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("variant", CUDA_VARIANTS)
def test_cuda_fused_variant_matches_plain(variant):
    with _card() as dev:
        for B, S, D, C in ((64, 5994, 512, 200), (5, 1100, 40, 7)):
            _cuda_variant_case(dev, variant, B, S, D, C)


@pytest.mark.gpu
@pytest.mark.parametrize("agg", ["f32", "split"])
@pytest.mark.parametrize("dist", ["f32s2", "x3"])
def test_cuda_fused_variant_masks_nan_rows(dist, agg):
    """The s2 and x3 routes read raw, unprepared rows: a masked row (label
    -1) that holds NaN, and so a NaN self-norm, changes nothing."""
    with _card() as dev:
        for B, S, D, C in ((64, 5994, 512, 200), (5, 1100, 40, 7)):
            _cuda_variant_case(dev, dict(labels="compact", dist=dist, agg=agg, block_s=512), B,
                               S, D, C, nan_masked=True)


@pytest.mark.gpu
@pytest.mark.parametrize("stages", manual_pipe_lab.MANUAL_STAGES)
@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("block_s", [512, 1024, 2048, "k2"])
def test_cuda_manual_fused_matches_plain(precision, block_s, stages):
    """Every ring depth, with split tile counts that are no multiple of it
    (16 tiles of 16 f32 slices at block_s 1,024; 8 tiles of 3 slices at
    S = 1,500, D = 72, block_s 512), and ``"k2"``: the 1,024-row bank at
    K2's own split count (``_tc_splits``), several splits a block_s tile."""
    with _card() as dev:
        n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
        for B, S, D, C in ((64, 5994, 512, 200), (8, 5994, 512, 200), (5, 1500, 72, 9)):
            q, s, sy, _ = _nw_inputs(B=B, S=S, D=D, C=C)
            prep = prepare_support(torch.from_numpy(s).to(dev), sy, C, precision=precision,
                                   block_s=1024 if block_s == "k2" else block_s)
            qc = torch.from_numpy(q).to(dev, prep.s.dtype)
            rows = None
            if block_s == "k2":
                qb = manual_pipe_lab.manual_plan(B, prep.s.shape[0], prep.block_s, C, stages)[0]
                rows = F._tc_splits(prep.s.shape[0], -(-B // qb), n_sms)[0]
            got = manual_pipe_lab.manual_fused_cuda(qc, prep, C, stages, block_s=rows)
            want = manual_pipe_lab._manual_fused_plain(qc, prep, C)
            assert bool(torch.isfinite(got).all())
            torch.testing.assert_close(got, want, rtol=0,
                                       atol=2e-4 if precision == "f32" else 2e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("shape,n_blocks,tile", [
    ((4, 56, 56, 64), 2, None), ((2, 56, 56, 16), 1, None), ((3, 20, 13, 32), 2, None),
    ((2, 56, 56, 8), 2, None), ((2, 24, 24, 8), 1, None), ((2, 21, 19, 8), 3, None),
    ((2, 56, 56, 64), 1, None), ((2, 30, 30, 64), 3, None), ((2, 17, 23, 16), 3, None),
    ((2, 56, 56, 64), 2, 8), ((2, 56, 56, 64), 2, 16), ((1, 13, 29, 64), 2, 14)])
def test_cuda_fused_blocks_matches_plain(shape, n_blocks, tile):
    """Every channel count, one to three blocks, ragged images, and the
    tile timed beside the plan's (8 and 16 at layer1's width)."""
    with _card() as dev:
        rng = np.random.default_rng(7)
        x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev, torch.bfloat16)
        w, b = block_lab.pack_weights([block_lab.fold_bn(*c)
                                       for c in _block_weights(rng, shape[-1], n_blocks)])
        w, b = w.to(dev), b.to(dev)
        got = block_lab.fused_blocks_cuda(x, w, b, n_blocks, tile=tile)
        want = block_lab._fused_blocks_plain(x, w, b, n_blocks)
        assert bool(torch.isfinite(got.float()).all())
        assert block_lab.rel_to_max(got, want) <= 1e-2
        cos = torch.nn.functional.cosine_similarity(got.float().flatten(),
                                                    want.float().flatten(), dim=0)
        assert float(cos) >= 0.9999
