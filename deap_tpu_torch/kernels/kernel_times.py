"""Time K1, K2, K5 and P1 of a checkout of this package on the card.

    python deap_tpu_torch/kernels/kernel_times.py [--root DIR] [--label L]
        [--ablate] [--profile]

Imports ``deap_tpu_torch`` from ``DIR`` (default: the checkout that
holds this file), builds its kernels and prints one JSON line per kernel
and input, CUDA-event milliseconds per launch beside the card's name and
power limit:

* K1 ``launch_vary`` in float32, bfloat16 and int8 at the GA flagship's
  10⁶ × 100 (its knobs) and at the NSGA-II head's 10⁵ × 12 (its knobs:
  cxpb 0.6, mutpb 0.3, sigma 0.1, indpb 1/12; int8 scale 1), there also
  as device time with the launches queued (``device_ms``,
  :func:`queued_ms`): back to back from the host a launch of that size
  is charged its wrapper's Python;
* K2 ``launch_gather_vary`` at 10⁶ × 100 in float32, bfloat16 and int8
  (the flagship's shape and knobs; winners from a random order and
  random positions);
* K5 ``launch_hv3d_sweep`` (128 prefixes a partial) on 8192 uniform
  points at ref (1, 1, 1) and on 10⁵ points of the DTLZ2 front (the unit
  sphere's positive octant) at ref (1.1, 1.1, 1.1), float32 and float64;
* P1 ``launch_probe_stream_copy`` at rows 512, 2048 and 8192 on 2²⁰ ×
  128 float32, with ``copy_`` into a preallocated tensor timed beside
  it, and ``launch_probe_chain24``.

``--ablate`` adds K1 and K2 without mutation (mutpb 0) and as a gather
and copy (cxpb 0 too); ``--profile`` adds K5's device time by kernel;
``--only k1,k2,k5,p1`` times a subset.
Only the wrappers' public signatures are used, so two checkouts can be
timed in one call on one card (parent, change, change, parent).  Needs a
card; exits 1 without one.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

POP, DIM = 1_000_000, 100
KNOBS = (0.9, 0.5, 0.0, 0.3, 0.05)
HEAD_POP, HEAD_DIM = 100_000, 12
HEAD_KNOBS = (0.6, 0.3, 0.0, 0.1, 1.0 / 12)
PROBE_POP, PROBE_LANE = 1 << 20, 128


def cuda_ms(fn, reps: int, warm: int) -> float:
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def queued_ms(fn, reps: int = 20, warm: int = 3) -> float:
    """Device milliseconds a call of ``fn`` (kernel launches on the current
    stream), the host's launch work off the clock: the ``reps`` calls are
    queued while the card runs a sleep kernel long enough to cover their
    launching, and CUDA events bracket them on the card.  Timed back to
    back from the host instead (:func:`cuda_ms`), a launch of a few
    microseconds is charged its wrapper's tens of microseconds of
    Python.  The sleep doubles until the queue was full when it ended."""
    import time

    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    cycles = int((time.perf_counter() - t0) * 4e9) + 100_000
    events = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    for _ in range(8):
        events[0].record()
        torch.cuda._sleep(cycles)
        events[1].record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        queued_ms = (time.perf_counter() - t0) * 1e3
        events[2].record()
        torch.cuda.synchronize()
        if queued_ms < events[0].elapsed_time(events[1]):
            return events[1].elapsed_time(events[2]) / reps
        cycles *= 2
    raise RuntimeError("queued_ms: the launches outran every sleep")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path,
                    default=Path(__file__).resolve().parents[2])
    ap.add_argument("--label", default=None)
    ap.add_argument("--profile", action="store_true",
                    help="also print K5's device time by CUDA kernel")
    ap.add_argument("--ablate", action="store_true",
                    help="also time K1 and K2 without mutation and as a "
                    "copy")
    ap.add_argument("--only", default="k1,k2,k5,p1",
                    help="comma-separated subset of k1, k2, k5, p1")
    args = ap.parse_args(argv)
    only = set(args.only.split(","))
    sys.path.insert(0, str(args.root.resolve()))
    import torch
    if not torch.cuda.is_available():
        print("kernel_times.py needs a CUDA card", file=sys.stderr)
        return 1
    from deap_tpu_torch import kernels, random
    from deap_tpu_torch.ops import generation as G
    from deap_tpu_torch.ops import hypervolume as H
    from deap_tpu_torch.probes import card_line
    kernels.load()
    card = card_line()
    label = args.label or os.fspath(args.root)
    dev = torch.device("cuda")

    def emit(**fields):
        print(json.dumps({"root": label, "card": card, **fields}),
              flush=True)

    k_g, k_o, k_p, k_s, k_h = random.split(random.PRNGKey(0, device=dev), 5)
    genome = random.uniform(k_g, (POP, DIM), minval=-5.12, maxval=5.12)
    order = torch.argsort(random.uniform(k_o, (POP,))).to(torch.int32)
    pos = random.randint(k_p, (POP,), 0, POP)
    seed = G._seed_from_key(k_s)

    def variants(kn):
        out = {"flagship": torch.tensor(kn, dtype=torch.float32, device=dev)}
        if args.ablate:     # mutpb 0: no draw 3 or erf_inv; then no swap
            out["no mutation"] = torch.tensor(
                (kn[0], 0.0) + kn[2:], dtype=torch.float32, device=dev)
            out["copy"] = torch.tensor(
                (0.0, 0.0) + kn[2:], dtype=torch.float32, device=dev)
        return out

    head = random.uniform(k_h, (HEAD_POP, HEAD_DIM))
    for st, head_st in ((G.GenomeStorage("float32"),) * 2,
                        (G.GenomeStorage("bfloat16"),) * 2,
                        (G.GenomeStorage("int8", 5.12),
                         G.GenomeStorage("int8", 1.0))):
        if not only & {"k1", "k2"}:
            break
        gs = st.to_storage(genome)
        hs = head_st.to_storage(head)
        for variant, kn in variants(KNOBS).items():
            if "k1" in only:
                ms = cuda_ms(lambda: kernels.launch_vary(
                    gs, seed, kn, dim=DIM, dtype=st.dtype, scale=st.scale),
                    reps=20, warm=3)
                emit(kernel="megakernel_vary", dtype=st.dtype,
                     shape=[POP, DIM], knobs=variant, ms=ms)
            if "k2" in only:
                ms = cuda_ms(lambda: kernels.launch_gather_vary(
                    order, pos, gs, seed, kn, dim=DIM, dtype=st.dtype,
                    scale=st.scale), reps=20, warm=3)
                emit(kernel="megakernel_gather_vary", dtype=st.dtype,
                     shape=[POP, DIM], knobs=variant, ms=ms)
        for variant, kn in variants(HEAD_KNOBS).items():
            if "k1" not in only:
                break

            def head_call():
                kernels.launch_vary(hs, seed, kn, dim=HEAD_DIM,
                                    dtype=head_st.dtype, scale=head_st.scale)
            emit(kernel="megakernel_vary", dtype=st.dtype,
                 shape=[HEAD_POP, HEAD_DIM], knobs=f"NSGA-II head {variant}",
                 ms=cuda_ms(head_call, reps=50, warm=5),
                 device_ms=queued_ms(head_call, reps=50, warm=5))
        del gs, hs
    del genome, head
    torch.cuda.empty_cache()

    if "p1" in only:
        x = random.uniform(k_o, (PROBE_POP, PROBE_LANE))
        into = torch.empty_like(x)
        for rows in (512, 2048, 8192):
            ms = cuda_ms(lambda: kernels.launch_probe_stream_copy(
                x, rows=rows), reps=20, warm=3)
            lib = cuda_ms(lambda: into.copy_(x), reps=20, warm=3)
            emit(kernel="probe_stream_copy", rows=rows,
                 shape=[PROBE_POP, PROBE_LANE], ms=ms, copy_ms=lib,
                 tb_per_s=2 * x.numel() * 4 / ms / 1e9)
        ms = cuda_ms(lambda: kernels.launch_probe_chain24(x), reps=20,
                     warm=3)
        emit(kernel="probe_chain24", shape=[PROBE_POP, PROBE_LANE], ms=ms)
        del x, into
        torch.cuda.empty_cache()
    if "k5" not in only:
        return 0

    k_u, k_f = random.split(k_h)
    sphere = random.uniform(k_f, (100_000, 3)) + 1e-3
    sphere = sphere / sphere.norm(dim=1, keepdim=True)
    for name, pts, ref in (
            ("8192 uniform", random.uniform(k_u, (8192, 3)), (1.0,) * 3),
            ("1e5 DTLZ2 front", sphere, (1.1,) * 3)):
        for dtype in (torch.float32, torch.float64):
            clipped, r = H._as_points(pts.to(dtype), ref)
            _, ys, zr, dz, width = H._hv3d_prep(clipped, r)
            ys, zr, width, dz = (t.contiguous() for t in (ys, zr, width, dz))
            ref_y = float(torch.tensor(ref, dtype=dtype)[1])
            ms = cuda_ms(lambda: kernels.launch_hv3d_sweep(
                ys, zr, width, dz, ref_y, threads=128), reps=10, warm=2)
            by = _device_ms(lambda: kernels.launch_hv3d_sweep(
                ys, zr, width, dz, ref_y, threads=128)) if args.profile \
                else None
            emit(kernel="hv3d_sweep", input=name, n=pts.shape[0],
                 dtype=str(dtype).split(".")[1], ms=ms, device_ms_by=by)
    return 0


def _device_ms(fn, reps: int = 5) -> dict:
    """Device ms a call of ``fn`` by CUDA kernel (``torch.profiler``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        t = getattr(ev, "device_time_total", None)
        if t is None:
            t = getattr(ev, "cuda_time_total", 0)
        if t:
            out[ev.key[:60]] = t / 1e3 / reps
    return out


if __name__ == "__main__":
    sys.exit(main())
