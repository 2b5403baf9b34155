"""The port's big-bank lab (``nwhead_tpu_torch/labs/bigbank_lab.py``)
against the JAX package's ``scripts/bigbank_lab.py``.

JAX's own smoke assertions (``tests/test_pallas_nw.py``'s
``test_bigbank_lab_smoke`` and ``test_bigbank_lab_giant_ivf_smoke``) run
against the port's ``main`` with ``--device cpu``. Then each leg takes the
same seeded numpy bank as JAX's functions, at ``--tiny``'s shapes (S_check
2,048, D=512, C=300, B=8; giant chunks of 4,096 rows), with the Pallas
kernels in interpret mode: the validation leg's oracle and heads against
JAX's ``nw_streaming_log_probs`` and ``prepare_support`` +
``nw_fused_log_probs`` at every precision; the giant leg's centroid and
routed outputs against JAX's ``concat_prepared`` / ``concat_ivf`` of the
same chunks. Probabilities agree within 1e-6 everywhere: the same rows,
codes and scales, summed in another order. The HNSW leg's recall equal to
JAX's ``_hnsw_leg``'s (both packages build the same graph from the same
rows). The bytes rule: a batch reads the bank once per query tile, 2 and 8
times at B=64 and 256 for C=1,000 on an H100. ``scripts/`` is imported by
path inside the tests.
"""

import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

from nwhead_tpu_torch.labs import bigbank_lab as L
from nwhead_tpu_torch.ops import fused_nw as F

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S_CHECK, D, C, B = 2048, 512, 300, 8
PROB_TOL = 1e-6


def _jax_lab():
    saved = list(sys.path)
    sys.path[:0] = [REPO, os.path.join(REPO, "scripts")]
    try:
        spec = importlib.util.spec_from_file_location(
            "_jax_bigbank_lab", os.path.join(REPO, "scripts", "bigbank_lab.py"))
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module
    finally:
        sys.path[:] = saved


def _bank(S, seed, class_sorted=False, n_chunks=1):
    """``(chunks, centroids)``: ``n_chunks`` of ``S`` rows ``(features,
    labels)`` around one set of class centroids, the lab's distribution."""
    rng = np.random.default_rng(seed)
    cents = (0.1 * rng.standard_normal((C, D))).astype(np.float32)
    chunks = []
    for _ in range(n_chunks):
        sy = rng.integers(0, C, S).astype(np.int32)
        if class_sorted:
            sy = np.sort(sy)
        chunks.append(((cents[sy] + 0.05 * rng.standard_normal((S, D))).astype(np.float32), sy))
    return chunks, cents


def test_bigbank_lab_smoke(capsys):
    """JAX's ``test_bigbank_lab_smoke`` on the port's ``main``: the four
    oracle gates, the tiny smoke line, the HNSW leg's recall line and the
    host-stream leg's report."""
    assert L.main(["--tiny", "--hnsw", "--hnsw_s", "1024", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "FAIL" not in out
    assert out.count("OK ") == 4  # f32/bf16/int8/int4 oracle gates
    assert "tiny smoke OK" in out
    assert "recall@10" in out
    assert L.main(["--stream_host", "4096", "--C", "50", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "[stream_host]" in out and "q/s" in out
    assert "regime boundary" in out


def test_bigbank_lab_giant_ivf_smoke(capsys):
    """JAX's ``test_bigbank_lab_giant_ivf_smoke``: the chunked IVF build
    passes the centroid gate and the routed skew gate."""
    assert L.main(["--tiny", "--giant", "8192", "--giant_ivf", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "FAIL" not in out
    assert "routed (n_probe=4) skew-query top-1: 1.000" in out


def test_lab_refuses_card_less_cuda_and_plain_tile():
    """No card: ``--device cuda`` (the default) raises; ``--giant_block_s``
    without ``--giant_ivf`` is refused by name (the plain bank is
    untiled)."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            L.main(["--tiny"])
    with pytest.raises(ValueError, match="giant_block_s"):
        L.main(["--tiny", "--giant", "4096", "--giant_block_s", "512", "--device", "cpu"])


def test_validation_leg_matches_jax():
    """The validation leg on a numpy bank: its streaming oracle and each
    prepared head against JAX's on the same arrays."""
    import jax.numpy as jnp

    from nwhead_tpu.nw.streaming import nw_streaming_log_probs
    from nwhead_tpu.ops.pallas_nw import nw_fused_log_probs, prepare_support

    [(bank, sy)], cents = _bank(S_CHECK, 0)
    rng = np.random.default_rng(1)
    q = (cents[rng.integers(0, C, B)] + 0.05 * rng.standard_normal((B, D))).astype(np.float32)
    got = L.validation_leg(torch.from_numpy(bank), torch.from_numpy(sy), torch.from_numpy(q), C)
    assert all(got[p]["ok"] for p in L.TOLS)
    chunk = L.ORACLE_CHUNK if S_CHECK >= L.ORACLE_CHUNK else S_CHECK
    oracle = np.asarray(nw_streaming_log_probs(
        jnp.asarray(q), ((bank[i:i + chunk], sy[i:i + chunk]) for i in range(0, S_CHECK, chunk)),
        C))
    np.testing.assert_allclose(np.exp(got["oracle"].numpy()), np.exp(oracle), rtol=0,
                               atol=PROB_TOL)
    for prec in L.TOLS:
        prep = prepare_support(jnp.asarray(bank), jnp.asarray(sy), C, precision=prec)
        want = np.asarray(nw_fused_log_probs(jnp.asarray(q), prep, None, C))
        np.testing.assert_allclose(np.exp(got[prec]["out"].numpy()), np.exp(want), rtol=0,
                                   atol=PROB_TOL, err_msg=prec)
        assert np.array_equal(got[prec]["out"].numpy().argmax(1), want.argmax(1)), prec


@pytest.mark.parametrize("ivf", [False, True], ids=["concat_prepared", "concat_ivf"])
def test_giant_leg_matches_jax(ivf):
    """The giant leg over two numpy chunks against JAX's chunked build of
    the same chunks: the centroid queries (and with IVF the routed skew
    queries at n_probe=4) give the same log-probs."""
    import jax.numpy as jnp

    from nwhead_tpu.ops.ivf import concat_ivf, nw_fused_ivf_log_probs, prepare_support_ivf
    from nwhead_tpu.ops.pallas_nw import concat_prepared, nw_fused_log_probs, prepare_support

    chunks, cents = _bank(4096, 5, class_sorted=ivf, n_chunks=2)
    res = L.giant_leg(((torch.from_numpy(f), torch.from_numpy(y)) for f, y in chunks),
                      torch.from_numpy(cents), C, B, precision="int8", ivf=ivf)
    assert res["ok"] and res["rows"] == 8192
    rng = np.random.default_rng(2)
    q_cls = rng.permutation(C)[:max(B, 64)]
    q = jnp.asarray(cents[q_cls])
    if ivf:
        parts = [prepare_support_ivf(jnp.asarray(f), jnp.asarray(y), C, precision="int8",
                                     block_s=1024) for f, y in chunks]
        bank = concat_ivf(parts, C)
        want = np.asarray(nw_fused_log_probs(q, bank.prep, None, C))
        skew = rng.choice(rng.permutation(C)[:8], max(B, 256))
        want_r = np.asarray(nw_fused_ivf_log_probs(jnp.asarray(cents[skew][:64]), bank, C,
                                                   n_probe=L.GIANT_PROBE))
        np.testing.assert_allclose(np.exp(res["out_routed"].numpy()), np.exp(want_r), rtol=0,
                                   atol=PROB_TOL)
    else:
        parts = [prepare_support(jnp.asarray(f), jnp.asarray(y), C, precision="int8")
                 for f, y in chunks]
        want = np.asarray(nw_fused_log_probs(q, concat_prepared(parts, C), None, C))
    np.testing.assert_allclose(np.exp(res["out"].numpy()), np.exp(want), rtol=0, atol=PROB_TOL)


def test_hnsw_leg_recall_matches_jax():
    """The HNSW leg's recall@k equals JAX's ``_hnsw_leg``'s on the same
    rows and queries."""
    [(bank, sy)], cents = _bank(1024, 3)
    rng = np.random.default_rng(4)
    q = (cents[rng.integers(0, C, B)] + 0.05 * rng.standard_normal((B, D))).astype(np.float32)
    _, recall, build_s = L.hnsw_leg(bank, sy, q, 10)
    _, want = _jax_lab()._hnsw_leg(bank, sy, q, 10)
    assert recall == want and build_s > 0


def test_bytes_rule():
    """A batch streams the bank once per query tile (``_tc_query_tile``:
    32 at C=1,000 on an H100): 2 passes at B=64, 8 at B=256; and the bank's
    bytes are its per-row fields."""
    assert L.passes(64, 1000) == L.passes(64, 1000, "cpu") == 2
    assert L.passes(256, 1000) == 8
    assert L.passes(8, 300) == 1
    assert F.query_tile(256, 1000) == F._tc_query_tile(256, 1000, False, F.H100_SMEM_OPTIN)
    [(bank, sy)], _ = _bank(1000, 7)
    for prec, per_row in (("f32", 4 * D + 8), ("int8", D + 12), ("int4", D // 2 + 12)):
        prep = F.prepare_support(torch.from_numpy(bank), sy, C, precision=prec)
        assert L.bank_bytes(prep) == 1000 * per_row, prec


@pytest.mark.parametrize("prec", ["f32", "bf16", "int8", "int4"])
def test_plain_reference_over_row_chunks(prec):
    """The lab's reference, ``nw_prepared_plain``: on the CPU it is the
    head itself, bit for bit; over row chunks whose partials merge it is
    the one-pass answer within 1e-5; ``nw_ivf_plain`` is the routed head's
    answer on the same tiles. ``plain_gate`` passes the head and fails one
    moved by ten times its tolerance."""
    from nwhead_tpu_torch.ops.ivf import nw_fused_ivf_log_probs, nw_ivf_plain, prepare_support_ivf

    [(bank, sy)], cents = _bank(4096, 11, class_sorted=True)
    rng = np.random.default_rng(12)
    q = torch.from_numpy((cents[rng.integers(0, C, B)]
                          + 0.05 * rng.standard_normal((B, D))).astype(np.float32))
    prep = F.prepare_support(torch.from_numpy(bank), torch.from_numpy(sy), C, precision=prec)
    got = F.nw_fused_from_prepared(q, prep, C)
    whole = F.nw_prepared_plain(q, prep, C)
    assert torch.equal(got, whole)
    np.testing.assert_allclose(F.nw_prepared_plain(q, prep, C, row_chunk=1000).numpy(),
                               whole.numpy(), rtol=0, atol=1e-5)
    assert L.plain_gate("head", got, whole, prec)[1]
    rtol, atol = L.PLAIN_TOL[prec]
    assert not L.plain_gate("moved", got + 10 * (atol + rtol * got.abs()), whole, prec)[1]
    ivf = prepare_support_ivf(torch.from_numpy(bank), torch.from_numpy(sy), C, precision=prec,
                              block_s=512)
    routed = nw_fused_ivf_log_probs(q, ivf, C, n_probe=L.GIANT_PROBE)
    assert torch.equal(routed, nw_ivf_plain(q, ivf, C, n_probe=L.GIANT_PROBE))
