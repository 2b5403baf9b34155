"""Big-bank lab: full-mode NW inference over a million-row bank on one card.

Port of ``scripts/bigbank_lab.py``. The prepared bank stays in device
memory and the prepared head (K2; K4 and K5 for int8 and int4 banks)
streams it once per query tile, so the bank's size is bounded by the
card's memory, not by a host link. The bank is class-clustered (centroids
``0.1 N(0, 1)``, noise ``0.05 N(0, 1)``, made on the device from a
``torch.Generator``), D=512, C=1,000 (the C > 128 class-sorted branch).
Legs, as in the JAX lab:

* validation (``--S_check``, 131,072 rows): each prepared head (f32, bf16,
  int8, int4) against the exact streaming oracle ``nw_streaming_log_probs``
  (K1 ``partials`` over 16,384-row host chunks), gated in probability
  space (max |dp| 2e-2 / 5e-2 / 1e-1 / 2e-1) and by top-1 agreement (1.0
  for f32, ``1 - 2/B`` for the rest);
* scale (``--S``, 1,000,000 rows): the four precisions resident, their
  top-1 agreement with f32, each at B=64 and 256 against its plain
  version, and B=64 at every precision and B=256 at int8
  and int4 timed in turns (``labs/timing.py``, L2 flushed) beside the
  stream yardstick K13 at 196,608 rows (403 MB; the JAX lab's 12,288-row
  bank, 25.2 MB, fits the card's L2 and is printed beside it), each with
  ``frac_vs_stream`` and ``frac_vs_peak`` (3.35 TB/s) of the bytes a batch
  reads: the bank's per-row fields once per query tile (``passes``);
* ``--hnsw``: the host C++ HNSW (M=16, efC=100) over an ``--hnsw_s``-row
  slice: build seconds, q/s and recall@k against a chunked f64 brute
  force, beside the exact int8 head's q/s over the whole bank;
* ``--giant N``: an int8 (or int4) bank of N rows built chunk by chunk
  (``prepare_support`` per chunk, ``concat_prepared``; with
  ``--giant_ivf`` ``prepare_support_ivf`` per class-sorted chunk and
  ``concat_ivf``), so the f32 bank never exists whole; a centroid-query
  gate, with IVF a routed skew-query gate at ``n_probe=4`` (K6), each
  timed head against its plain version, then timing;
* ``--stream_host N``: an N-row bank in host memory through
  ``nw_streaming_log_probs`` in 65,536-row chunks, copied plainly: the
  link's MB/s and the regime boundary.

Every head a leg runs is also held to its plain version on the same bank
and queries (``nw_prepared_plain``, ``nw_ivf_plain``; over row chunks
whose partials merge exactly where the bank is large) within ``PLAIN_TOL``,
the tolerances ``chip_smoke.py`` holds the prepared heads to; the streaming
oracle's K1 shares pass 1 with K2, K4 and K5, so it alone would not catch
a fault there. Each leg returns its gates as ``(name, ok)`` pairs.

Every leg takes its bank, labels and queries as arguments, so a test feeds
this lab and the JAX package the same numpy arrays::

    python -m nwhead_tpu_torch.labs.bigbank_lab [--hnsw --hnsw_s 8192]
    python -m nwhead_tpu_torch.labs.bigbank_lab --giant 8000000 [--giant_ivf]
    python -m nwhead_tpu_torch.labs.bigbank_lab --stream_host 1048576
    python -m nwhead_tpu_torch.labs.bigbank_lab --device cpu --tiny

``--tiny`` (S=4,096, ``S_check`` 2,048, C=300, B=8, giant at most 8,192
rows) checks the gates only; on the CPU the plain versions run and nothing
is timed.
"""

from __future__ import annotations

import argparse
import math
import sys
import time
from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from nwhead_tpu_torch.labs import stream as lab_stream
from nwhead_tpu_torch.labs.timing import card_line, interleaved_time, lab_device

PEAK_BYTES_PER_S = 3.35e12  # the H100's HBM rate, PERF.md's bounds
STREAM_ROWS = 196_608  # the yardstick bank, 403 MB at D=512: past the 50 MB L2
SMALL_STREAM_ROWS = 12_288  # the JAX lab's, 25.2 MB: inside the L2
TOLS = {"f32": 2e-2, "bf16": 5e-2, "int8": 1e-1, "int4": 2e-1}
# Kernel vs plain version, (rtol, atol) on the log-probs: f32 as the JAX
# kernel is held to its naive op; bf16 products summed in another order;
# int8/int4 products exact in both, the rest in f32.
PLAIN_TOL = {"f32": (2e-4, 2e-4), "bf16": (0.0, 2e-3), "int8": (2e-4, 2e-4),
             "int4": (2e-4, 2e-4)}
ORACLE_CHUNK = 16_384
HOST_CHUNK = 65_536
GIANT_CHUNK = 1 << 20
# IVF builds take half: the JAX lab's first 8M-row IVF build at 1M-row
# chunks ran out of a 16 GB chip's memory (the chunk's transients on top of
# the parts already built). An 80 GB card has room; the rule is kept.
GIANT_IVF_CHUNK = 1 << 19
GIANT_PROBE = 4
CYCLES = 7


def _gen_bank(S: int, D: int, C: int, seed: int, device) -> Tuple[torch.Tensor, ...]:
    """``(bank (S, D), labels (S,) int32, centroids (C, D))`` on ``device``:
    each row its class's centroid plus noise. The 0.1 scale keeps squared
    distances O(10), so the softmax concentrates without f32 rounding of
    O(1000) scores moving the log-probs."""
    g = torch.Generator(device=device).manual_seed(seed)
    sy = torch.randint(0, C, (S,), generator=g, device=device, dtype=torch.int32)
    cents = 0.1 * torch.randn((C, D), generator=g, device=device)
    return cents[sy] + 0.05 * torch.randn((S, D), generator=g, device=device), sy, cents


def bank_bytes(prep) -> int:
    """Bytes of a prepared bank's per-row fields: codes or features,
    self-norms, labels, int8/int4 row scales."""
    return sum(t.numel() * t.element_size()
               for t in (prep.s, prep.s2, prep.labels, prep.sscale) if t is not None)


def passes(B: int, C: int, device=None) -> int:
    """Times a batch of B reads the bank on ``device``: once per query tile
    of the tensor-core pass 1 (``ops/fused_nw.py:query_tile``; off a card,
    an H100's)."""
    from nwhead_tpu_torch.ops.fused_nw import query_tile

    return math.ceil(B / query_tile(B, C, device))


def _gate(ok: bool) -> str:
    return "OK " if ok else "FAIL"


def plain_gate(name: str, got: torch.Tensor, want: torch.Tensor, prec: str) -> Tuple[str, bool]:
    """``got`` (a head's log-probs) against ``want`` (its plain version's)
    within ``PLAIN_TOL[prec]``, printed ``ok`` or ``FAIL``: ``(name, ok)``."""
    rtol, atol = PLAIN_TOL[prec]
    got, want = got.float().cpu(), want.float().cpu()
    diff = (got - want).abs()
    ok = bool(torch.isfinite(got).all()) and bool((diff <= atol + rtol * want.abs()).all())
    print(f"  vs plain {name}: max|err| {float(diff.max()):.2e} (rtol {rtol:g}, atol "
          f"{atol:g}) {'ok' if ok else 'FAIL'}", flush=True)
    return f"plain {name}", ok


def validation_leg(bank: torch.Tensor, sy: torch.Tensor, q: torch.Tensor, C: int,
                   chunk: int = ORACLE_CHUNK) -> Dict[str, dict]:
    """Each prepared head against the streaming oracle over host chunks of
    the same bank, and against its plain version: ``{"oracle": log-probs,
    prec: {"out", "err", "agree", "ok", "plain_ok"}, "gates": [(name,
    ok)]}``, each gate printed."""
    from nwhead_tpu_torch.nw.streaming import nw_streaming_log_probs
    from nwhead_tpu_torch.ops.fused_nw import (
        nw_fused_from_prepared, nw_prepared_plain, prepare_support,
    )

    S, B = bank.shape[0], q.shape[0]
    chunk = min(chunk, S)
    host, host_sy = bank.cpu().numpy(), sy.cpu().numpy()
    oracle = nw_streaming_log_probs(
        q, ((host[i:i + chunk], host_sy[i:i + chunk]) for i in range(0, S, chunk)), C).cpu()
    out: Dict[str, dict] = {"oracle": oracle}
    gates = []
    for prec, tol in TOLS.items():
        prep = prepare_support(bank, sy, C, precision=prec)
        got = nw_fused_from_prepared(q, prep, C).cpu()
        # Probability space: log-space relative error is ill-conditioned at
        # both ends (the 1e-12 floor, and the winner near log 1 = 0).
        err = float(torch.max(torch.abs(torch.exp(got) - torch.exp(oracle))))
        agree = float((got.argmax(1) == oracle.argmax(1)).to(torch.float32).mean())
        min_agree = 1.0 if prec == "f32" else 1.0 - 2.0 / B
        ok = err < tol and agree >= min_agree
        print(f"  {_gate(ok)} S={S} {prec}: max prob err vs streaming-oracle {err:.2e}  "
              f"top1-agree {agree:.3f}", flush=True)
        gates += [(f"oracle S={S} {prec}", ok),
                  plain_gate(f"S={S} B={B} {prec}", got, nw_prepared_plain(q, prep, C), prec)]
        out[prec] = {"out": got, "err": err, "agree": agree, "ok": ok, "plain_ok": gates[-1][1]}
        del prep
    out["gates"] = gates
    return out


def _stream_cases(D: int, device) -> Tuple[list, Dict[str, int]]:
    """The yardstick K13 at ``STREAM_ROWS`` and at the JAX lab's
    ``SMALL_STREAM_ROWS``: ``(cases, {name: bytes})``."""
    rng = np.random.default_rng(7)
    cases, nbytes = [], {}
    for rows in (STREAM_ROWS, SMALL_STREAM_ROWS):
        (_, fn, args), n = lab_stream.stream_case(rng, D, rows, device)
        name = f"stream {n / 1e6:.1f}MB"
        cases.append((name, fn, args))
        nbytes[name] = n
    return cases, nbytes


def _report_times(res: Dict[str, float], nbytes: Dict[str, int],
                  heads: Dict[str, Tuple[int, Optional[int]]]) -> Dict[str, dict]:
    """Print the streams' rates and each head's ms/batch, q/s and, where its
    bytes are given, ``frac_vs_stream`` (against the 403 MB stream) and
    ``frac_vs_peak``."""
    out = {}
    for name, n in nbytes.items():
        t = res[name]
        out[name] = {"ms": t * 1e3, "gbps": n / t / 1e9}
        print(f"{name}: {t * 1e6:8.1f} us  {n / t / 1e9:7.1f} GB/s (L2 flushed)", flush=True)
    rate = next(iter(nbytes.values())) / res[next(iter(nbytes))]
    for name, (nq, nbyte) in heads.items():
        t = res[name]
        r = {"ms": t * 1e3, "qps": nq / t}
        line = f"{name}: {t * 1e3:8.3f} ms/batch  {nq / t:9.0f} q/s"
        if nbyte is not None:
            r.update(bytes=nbyte, frac_vs_stream=nbyte / rate / t,
                     frac_vs_peak=nbyte / PEAK_BYTES_PER_S / t)
            line += (f" frac_vs_stream={r['frac_vs_stream']:5.3f} "
                     f"frac_vs_peak={r['frac_vs_peak']:5.3f}")
        out[name] = r
        print(line, flush=True)
    return out


def scale_leg(preps: dict, q: torch.Tensor, q256: torch.Tensor, C: int, timed: bool) -> dict:
    """Top-1 agreement of each precision with f32 at scale, each precision
    at both batches against its plain version (``gates``), then
    (``timed``) B=64 at every precision and B=256 at int8 and int4 beside
    the stream."""
    from nwhead_tpu_torch.ops.fused_nw import nw_fused_from_prepared, nw_prepared_plain

    S = preps["f32"].labels.shape[0]
    gates, top1 = [], {}
    for prec, prep in preps.items():
        for qq in (q, q256):
            got = nw_fused_from_prepared(qq, prep, C)
            if qq is q:
                top1[prec] = got.argmax(1)
            gates.append(plain_gate(f"S={S} B={qq.shape[0]} {prec}", got,
                                    nw_prepared_plain(qq, prep, C, row_chunk=GIANT_CHUNK), prec))
            del got
    agree = {}
    for prec in ("bf16", "int8", "int4"):
        agree[prec] = float((top1[prec] == top1["f32"]).to(torch.float32).mean())
        print(f"  at-scale f32-vs-{prec}: top1 agreement {agree[prec]:.3f}", flush=True)
    if not timed:
        return {"agree": agree, "gates": gates}

    def head(qq, prep):
        return nw_fused_from_prepared(qq, prep, C)

    dev = q.device
    cases, nbytes = _stream_cases(q.shape[1], dev)
    heads = {}
    for prec, prep in preps.items():
        cases.append((f"head B={q.shape[0]} {prec}", head, (q, prep)))
        heads[cases[-1][0]] = (q.shape[0], bank_bytes(prep) * passes(q.shape[0], C, dev))
    for prec in ("int8", "int4"):
        cases.append((f"head B={q256.shape[0]} {prec}", head, (q256, preps[prec])))
        heads[cases[-1][0]] = (q256.shape[0],
                               bank_bytes(preps[prec]) * passes(q256.shape[0], C, dev))
    res = interleaved_time(cases, cycles=CYCLES)
    return {"agree": agree, "gates": gates, "times": _report_times(res, nbytes, heads)}


def hnsw_leg(bank_np: np.ndarray, sy_np: np.ndarray, q_np: np.ndarray,
             k: int) -> Tuple[float, float, float]:
    """The host ANN the reference uses for large banks, on the port's C++
    HNSW (M=16, efC=100): ``(queries/s, recall@k, build seconds)``, recall
    against a chunked f64 brute force."""
    from nwhead_tpu_torch.native.hnsw import HNSWIndex

    Sh = bank_np.shape[0]
    print(f"[hnsw] building C++ HNSW over S={Sh} (M=16, efC=100, one host core)...",
          flush=True)
    t0 = time.perf_counter()
    idx = HNSWIndex(bank_np, sy_np, n_neighbors=k)
    build_s = time.perf_counter() - t0
    print(f"[hnsw] build {build_s:.1f} s ({Sh / build_s:.0f} rows/s)", flush=True)
    idx.knn_query(q_np)  # warm
    reps, t0 = 5, time.perf_counter()
    for _ in range(reps):
        ids = idx.knn_query(q_np)
    qps = q_np.shape[0] / ((time.perf_counter() - t0) / reps)
    q64 = q_np.astype(np.float64)
    qn = (q64 ** 2).sum(1)[:, None]
    ids_parts, d_parts = [], []
    for i in range(0, Sh, HOST_CHUNK):
        blk = bank_np[i:i + HOST_CHUNK].astype(np.float64)
        d = qn - 2.0 * q64 @ blk.T + (blk ** 2).sum(1)[None]
        part = np.argpartition(d, k - 1, axis=1)[:, :k]
        ids_parts.append(part + i)
        d_parts.append(np.take_along_axis(d, part, 1))
    ids_all = np.concatenate(ids_parts, 1)
    sel = np.argpartition(np.concatenate(d_parts, 1), k - 1, 1)[:, :k]
    true_ids = np.take_along_axis(ids_all, sel, 1)
    recall = float(np.mean([len(set(ids[b].tolist()) & set(true_ids[b].tolist())) / k
                            for b in range(q_np.shape[0])]))
    print(f"[hnsw] query rate {qps:.0f} q/s (B={q_np.shape[0]}, k={k}, one host core)  "
          f"recall@{k} {recall:.3f}", flush=True)
    return qps, recall, build_s


def giant_chunks(S: int, D: int, C: int, chunk: int, class_sorted: bool, device,
                 seed: int = 5):
    """``(centroids, chunks)``: ``chunks`` yields ``(features, labels)`` of
    ``chunk`` rows (the last fewer) made on ``device`` one at a time; each
    chunk's labels sorted with ``class_sorted`` (an IVF build's order, so
    its permutation is the identity)."""
    g = torch.Generator(device=device).manual_seed(seed)
    cents = 0.1 * torch.randn((C, D), generator=g, device=device)

    def gen():
        for i in range(0, S, chunk):
            n = min(chunk, S - i)
            sy = torch.randint(0, C, (n,), generator=g, device=device, dtype=torch.int32)
            if class_sorted:
                sy = torch.sort(sy).values
            yield cents[sy] + 0.05 * torch.randn((n, D), generator=g, device=device), sy

    return cents, gen()


def giant_leg(chunks: Iterable, cents: torch.Tensor, C: int, B: int, *,
              precision: str = "int8", ivf: bool = False, block_s: int = 0,
              timed: bool = False) -> dict:
    """A bank built chunk by chunk at ``precision`` (module docstring),
    the centroid-query gate (one query per class at its centroid must
    classify to it), with ``ivf`` the routed skew gate at ``n_probe=4``,
    each head the timing runs (B=64 and 256, routed too) against its plain
    version over ``GIANT_CHUNK``-row chunks, then (``timed``) the timing."""
    from nwhead_tpu_torch.ops.fused_nw import (
        concat_prepared, nw_fused_from_prepared, nw_prepared_plain, prepare_support,
    )
    from nwhead_tpu_torch.ops.ivf import (
        concat_ivf, nw_fused_ivf_log_probs, nw_ivf_plain, prepare_support_ivf,
    )

    if block_s and not ivf:
        raise ValueError("--giant_block_s sets the IVF tile (--giant_ivf): the plain bank is "
                         "untiled")
    device = cents.device
    t0 = time.perf_counter()
    parts, S = [], 0
    for feats, sy in chunks:
        S += feats.shape[0]
        if ivf:
            parts.append(prepare_support_ivf(feats, sy, C, precision=precision,
                                             block_s=block_s or None))
        else:
            parts.append(prepare_support(feats, sy, C, precision=precision))
        del feats, sy
    bank_ivf = concat_ivf(parts) if ivf else None
    prep = bank_ivf.prep if ivf else concat_prepared(parts)
    n_chunks = len(parts)
    del parts
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    build_s = time.perf_counter() - t0
    gbytes = bank_bytes(prep) / 1e9
    print(f"[giant] {precision} bank S={S} D={cents.shape[1]} C={C}: {gbytes:.2f} GB resident "
          f"({n_chunks} chunks{', IVF tile ' + str(prep.block_s) if ivf else ''}), built in "
          f"{build_s:.1f}s", flush=True)
    res = {"rows": S, "gbytes": gbytes, "build_s": build_s, "chunks": n_chunks}

    rng = np.random.default_rng(2)
    q_cls = rng.permutation(C)[:max(B, 64)]
    q = cents[torch.as_tensor(q_cls, device=device)]
    out = nw_fused_from_prepared(q, prep, C).cpu()
    res["out"] = out
    res["agree"] = float((out.argmax(1).numpy() == q_cls).mean())
    print(f"  {_gate(res['agree'] == 1.0)} centroid-query top-1 = generating class: "
          f"{res['agree']:.3f}", flush=True)
    gates = [("centroid", res["agree"] == 1.0)]
    if ivf:
        active = rng.permutation(C)[:8]
        skew_cls = rng.choice(active, max(B, 256))
        q_skew = cents[torch.as_tensor(skew_cls, device=device)]
        out_r = nw_fused_ivf_log_probs(q_skew[:64], bank_ivf, C, n_probe=GIANT_PROBE).cpu()
        res["out_routed"] = out_r
        res["agree_routed"] = float((out_r.argmax(1).numpy() == skew_cls[:64]).mean())
        print(f"  {_gate(res['agree_routed'] == 1.0)} routed (n_probe={GIANT_PROBE}) "
              f"skew-query top-1: {res['agree_routed']:.3f}", flush=True)
        gates.append(("routed", res["agree_routed"] == 1.0))
    q256 = torch.from_numpy(rng.standard_normal((256, cents.shape[1])).astype(np.float32)).to(
        device)
    for qq, got in ((q[:64], out[:64]), (q256, None)):
        got = nw_fused_from_prepared(qq, prep, C) if got is None else got
        gates.append(plain_gate(f"S={S} B={qq.shape[0]} {precision}", got,
                                nw_prepared_plain(qq, prep, C, row_chunk=GIANT_CHUNK), precision))
    if ivf:
        for nq in (64, 256):
            qq = q_skew[:nq]
            got = out_r if nq == 64 else nw_fused_ivf_log_probs(qq, bank_ivf, C,
                                                                n_probe=GIANT_PROBE)
            gates.append(plain_gate(f"S={S} routed n_probe={GIANT_PROBE} B={nq} {precision}",
                                    got, nw_ivf_plain(qq, bank_ivf, C, n_probe=GIANT_PROBE),
                                    precision))
    res["gates"] = gates
    res["ok"] = all(ok for _, ok in gates)
    if not timed:
        print("timing not measured (no card)", flush=True)
        return res

    def head(qq, pp):
        return nw_fused_from_prepared(qq, pp, C)

    def routed(qq, bb):
        return nw_fused_ivf_log_probs(qq, bb, C, n_probe=GIANT_PROBE)

    cases, nbytes = _stream_cases(cents.shape[1], device)
    heads = {}
    for name, qq in ((f"giant B=64 {precision}", q[:64]), (f"giant B=256 {precision}", q256)):
        cases.append((name, head, (qq, prep)))
        heads[name] = (qq.shape[0], bank_bytes(prep) * passes(qq.shape[0], C, device))
    if ivf:
        for nq in (64, 256):
            # Pruned: the bytes a batch reads depend on its union.
            name = f"giant ivf-p{GIANT_PROBE} B={nq} {precision} skew"
            cases.append((name, routed, (q_skew[:nq], bank_ivf)))
            heads[name] = (nq, None)
    res["times"] = _report_times(interleaved_time(cases, cycles=CYCLES), nbytes, heads)
    return res


def stream_host_leg(S: int, D: int, C: int, B: int, device, chunk: int = HOST_CHUNK) -> dict:
    """An S-row f32 bank in host memory through ``nw_streaming_log_probs``:
    every batch copies the whole bank to the card, so q/s is the link's
    bytes/s over the bank's bytes times B. The bank and queries are the
    JAX lab's (numpy seed 9); the second call is timed."""
    from nwhead_tpu_torch.nw.streaming import nw_streaming_log_probs

    rng = np.random.default_rng(9)
    cents = rng.standard_normal((C, D)).astype(np.float32)
    sy = rng.integers(0, C, S).astype(np.int32)
    bank = (cents[sy] + 0.5 * rng.standard_normal((S, D))).astype(np.float32)
    q = torch.as_tensor((cents[rng.integers(0, C, B)]
                         + 0.1 * rng.standard_normal((B, D))).astype(np.float32), device=device)

    def call():
        return nw_streaming_log_probs(
            q, ((bank[i:i + chunk], sy[i:i + chunk]) for i in range(0, S, chunk)), C,
            chunk_size=chunk)

    float(call().sum())  # warm: the kernel's first launch, one whole pass
    t0 = time.perf_counter()
    out = call()
    finite = bool(torch.isfinite(out).all())
    wall = time.perf_counter() - t0
    nbytes = S * D * 4
    mbps = nbytes / wall / 1e6
    res = {"rows": S, "seconds": wall, "qps": B / wall, "link_mbps": mbps, "finite": finite,
           "chunks": math.ceil(S / chunk), "gates": [("finite", finite)]}
    print(f"[stream_host] S={S} ({nbytes / 1e9:.2f} GB host f32), B={B}, chunk={chunk}: "
          f"{wall:.3f} s/batch -> {B / wall:.3f} q/s (link {mbps:.1f} MB/s; extrapolated "
          f"16M-row f32 bank {B / (16e6 * D * 4 / (mbps * 1e6)):.4f} q/s)", flush=True)
    print("[stream_host] regime boundary: host streaming wins only when the bank fits the "
          "card's memory at no precision and no mesh is available; it pays the link for "
          "every byte of the bank on every batch", flush=True)
    return res


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--S", type=int, default=1_000_000)
    p.add_argument("--S_check", type=int, default=131_072,
                   help="validation-leg bank size (streaming oracle)")
    p.add_argument("--D", type=int, default=512)
    p.add_argument("--C", type=int, default=1000)
    p.add_argument("--tiny", action="store_true",
                   help="small shapes: S=4096/S_check=2048, C=300, B=8")
    p.add_argument("--hnsw", action="store_true",
                   help="host-ANN leg: the C++ HNSW over an --hnsw_s-row slice of the bank, "
                        "build time / query rate / recall@k against exact, beside the exact "
                        "int8 head")
    p.add_argument("--hnsw_s", type=int, default=131_072,
                   help="HNSW leg bank size (the build runs on one host core)")
    p.add_argument("--hnsw_k", type=int, default=10)
    p.add_argument("--giant_precision", default="int8", choices=["int8", "int4"],
                   help="giant-leg bank precision")
    p.add_argument("--giant", type=int, default=0,
                   help="rows of the chunked-build giant-bank leg (e.g. 8000000): chunks "
                        "are made, prepared at --giant_precision and concatenated, so the "
                        "f32 bank never exists whole. 0 = off")
    p.add_argument("--giant_block_s", type=int, default=0,
                   help="IVF tile rows of the giant build (--giant_ivf); 0 = "
                        "prepare_support_ivf's 1,024")
    p.add_argument("--giant_ivf", action="store_true",
                   help="build the giant bank as per-chunk IVF banks (prepare_support_ivf + "
                        "concat_ivf) and add the routed gate and timing")
    p.add_argument("--stream_host", type=int, default=0,
                   help="rows of the host-resident streaming leg: the whole bank crosses "
                        "the link every batch. 0 = off")
    p.add_argument("--device", default="cuda")
    return p


def run(argv=None) -> dict:
    """The legs ``argv`` asks for; their results, every gate as ``(name,
    ok)`` under ``gates``, and ``ok`` (no gate failed)."""
    from nwhead_tpu_torch.ops.fused_nw import prepare_support

    args = parser().parse_args(argv)
    dev = lab_device(args.device)
    if args.tiny:
        args.S, args.S_check, args.C = 4096, 2048, 300
        if args.giant:
            args.giant = min(args.giant, 8192)
    S, D, C = args.S, args.D, args.C
    B = 8 if args.tiny else 64
    timed = dev.type == "cuda" and not args.tiny
    print(f"card: {card_line(dev)}", flush=True)
    rng = np.random.default_rng(1)

    if args.stream_host:
        res = stream_host_leg(args.stream_host, D, C, B, dev, min(HOST_CHUNK, args.stream_host))
        return {"stream_host": res, "gates": res["gates"], "ok": res["finite"]}
    if args.giant:
        chunk = 4096 if args.tiny else (GIANT_IVF_CHUNK if args.giant_ivf else GIANT_CHUNK)
        cents, chunks = giant_chunks(args.giant, D, C, chunk, args.giant_ivf, dev)
        res = giant_leg(chunks, cents, C, B, precision=args.giant_precision, ivf=args.giant_ivf,
                        block_s=args.giant_block_s, timed=timed)
        return {"giant": res, "gates": res["gates"], "ok": res["ok"]}

    bank_v, sy_v, cents = _gen_bank(args.S_check, D, C, 0, dev)
    # Queries from the bank's own clusters: a query between two centroids
    # has its argmax flipped by bf16/int8 rounding legitimately.
    q = cents[torch.as_tensor(rng.integers(0, C, size=B), device=dev)] + 0.05 * torch.as_tensor(
        rng.standard_normal((B, D)).astype(np.float32), device=dev)
    val = validation_leg(bank_v, sy_v, q, C)
    out = {"validation": {p: {k: v for k, v in val[p].items() if k != "out"} for p in TOLS},
           "gates": val["gates"]}
    del bank_v, sy_v, val

    bank, sy, cents_s = _gen_bank(S, D, C, 3, dev)
    print(f"bank: S={S} D={D} C={C}  raw f32 {S * D * 4 / 1e9:.2f} GB", flush=True)
    preps = {prec: prepare_support(bank, sy, C, precision=prec)
             for prec in ("f32", "bf16", "int8", "int4")}
    out["resident_gb"] = {prec: bank_bytes(p) / 1e9 for prec, p in preps.items()}
    print("resident: " + ", ".join(f"{k} {v:.2f} GB" for k, v in out["resident_gb"].items()),
          flush=True)
    hnsw_rows = None
    if args.hnsw:
        hnsw_rows = min(args.hnsw_s, S)
        bank_np, sy_np = bank[:hnsw_rows].cpu().numpy(), sy[:hnsw_rows].cpu().numpy()
    del bank  # only the prepared banks stay resident
    q = cents_s[torch.as_tensor(rng.integers(0, C, size=B), device=dev)] + 0.05 * torch.as_tensor(
        rng.standard_normal((B, D)).astype(np.float32), device=dev)
    q256 = torch.as_tensor(rng.standard_normal((256, D)).astype(np.float32), device=dev)
    if args.hnsw:
        # Before the device timing, so its host work runs alone.
        qps, recall, build_s = hnsw_leg(bank_np, sy_np, q.cpu().numpy(), args.hnsw_k)
        out["hnsw"] = {"rows": hnsw_rows, "qps": qps, "recall": recall, "build_s": build_s}
        del bank_np, sy_np
    out["scale"] = scale_leg(preps, q, q256, C, timed)
    out["gates"] += out["scale"]["gates"]
    if args.tiny:
        print("tiny smoke OK", flush=True)
    elif not timed:
        print("timing not measured (no card)", flush=True)
    elif args.hnsw:
        int8_qps = out["scale"]["times"]["head B=256 int8"]["qps"]
        out["hnsw"]["int8_head_qps"] = int8_qps
        print(f"[hnsw] exact int8 full-mode head over S={S} answers {int8_qps:.0f} q/s on the "
              f"card vs {out['hnsw']['qps']:.0f} q/s for the host HNSW over S={hnsw_rows} "
              f"({int8_qps / out['hnsw']['qps']:.0f}x, and exact)", flush=True)
    out["ok"] = all(ok for _, ok in out["gates"])
    return out


def main(argv=None) -> int:
    return 0 if run(argv)["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
