"""Where the time of K6 goes: ablations of the ring halo exchange
(``radar_tpu_torch/csrc/ring.cu``, the port's ``halo_right_permute``) on one
NVIDIA GPU, at the range-sharded PC of a full frame (13 x 332 = 4316 rows
of complex64, 1455 samples a shard, halo 699, overlap-save rows of 4096).

    python3 scripts/ablate_ring.py [--rounds 3]

Builds copies of the source into ``build/ablate_ring/`` with parts of the
kernels taken out: the push's wait for the receive slot and its signal
(``no_signal``, which also takes out the fill's wait: nothing would set
its flag), the fill's wait alone (``fill_no_wait``), the copies of both
kernels (``signal_only``: what the waits, counts and flags cost alone),
and the lanes' loads in flight (``in_flight_16``: one 16-byte load before
each store instead of 64 bytes); the full copy also runs with its flags at
the system's scope (``full_sys``, as between cards) beside the GPU's (as
between the ranks of one card). Each copy runs a one-rank exchange that pushes
its halo into its own receive slot (the message the ring's first rank
gets carries data here, as every other rank's does), in turns with the
others; the push and fill kernels' device times come from torch.profiler
(median over the rounds of the mean of 20 exchanges). Beside them, with
the full source: the CUDA events around one exchange; the FFT input built
the old way (the push, then the receive kernel K6 had before its
overlap-save route, which waits for the halo and copies it out of the slot
into a fresh [rows, halo] tensor, then ``torch.cat`` and the zero pad),
against the push and fill; and ``copy_`` of the halo's bytes between
contiguous tensors and into the receive slot's halo columns. That old
receive kernel lives only here, appended to the full copy (``PULL``). The ablated copies may compute wrong values (timing only).
Prints one JSON line with the card's name and power limit. Needs the CUDA
toolkit and a card; imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

PUSH_WAIT = """    ok = seq < 3 ||
         wait_for<kSys>(&right->consumed, seq - 2, true, timeout_ns);
"""
PUSH_SIGNAL = """  if (threadIdx.x == 0 &&
      atom_add_acq_rel<kSys>(&own->push_blocks, 1u) == gridDim.x - 1) {
    own->push_blocks = 0;
    st_release<kSys>(&right->flag[p], seq);
  }
"""
FILL_WAIT = """  if (blockIdx.x == 0 && threadIdx.x == 0 &&
      !wait_for<kSys>(&own->flag[p], seq, false, timeout_ns))
    fail(own, status, kTimeoutHalo, seq);
"""
PUSH_COPY = """      copy_row(dst + r * dst_stride, src + r * src_stride, (int)row_bytes,
               lane);
"""
FILL_COPY = """    copy_row(slot + r * slot_stride, x + r * x_stride, (int)shard_bytes,
             lane);
"""
# The old receive: every block waits for the slot's flag, then the halo
# columns of its rows go to out [rows, halo] (GPU scope: one card).
PULL = """
namespace {
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
pull_kernel(Ctrl* own, long long slot_bytes, long long slot_stride, int rows,
            long long halo_bytes, char* __restrict__ out,
            unsigned long long seq, long long timeout_ns, Status* status) {
  __shared__ int ok;
  const int p = (int)(seq & 1);
  release_previous<false>(own, seq);
  if (threadIdx.x == 0)
    ok = wait_for<false>(&own->flag[p], seq, false, timeout_ns);
  __syncthreads();
  if (!ok) {
    if (threadIdx.x == 0) fail(own, status, kTimeoutHalo, seq);
    return;
  }
  const char* slot = slot_of(own, slot_bytes, p);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (long long r = (long long)blockIdx.x * kWarps + warp; r < rows;
       r += (long long)gridDim.x * kWarps)
    copy_row(out + r * halo_bytes, slot + r * slot_stride, (int)halo_bytes,
             lane);
}
}  // namespace

extern "C" int k6_pull(void* own, long long slot_bytes,
                       long long slot_stride, int rows, long long halo_bytes,
                       void* out, unsigned long long seq,
                       long long timeout_ns, void* status, int blocks,
                       void* stream) {
  pull_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<Ctrl*>(own), slot_bytes, slot_stride, rows, halo_bytes,
      static_cast<char*>(out), seq, timeout_ns,
      static_cast<Status*>(status));
  return (int)cudaGetLastError();
}
"""
_P, _LL, _I, _ULL = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                     ctypes.c_ulonglong)
PULL_SIGNATURE = [_P, _LL, _LL, _I, _LL, _P, _ULL, _LL, _P, _I, _P]
UNROLL = "constexpr int kLaneBytes = 64;"
CUTS = {"push_wait": (PUSH_WAIT, "    ok = 1;\n"),
        "push_signal": (PUSH_SIGNAL, ""),
        "fill_wait": (FILL_WAIT, ""),
        "push_copy": (PUSH_COPY, "      ;\n"),
        "fill_copy": (FILL_COPY, "    ;\n"),
        "unroll": (UNROLL, "constexpr int kLaneBytes = 16;")}
VARIANTS = {"full": (),
            "no_signal": ("push_wait", "push_signal", "fill_wait"),
            "fill_no_wait": ("fill_wait",),
            "signal_only": ("push_copy", "fill_copy"),
            "in_flight_16": ("unroll",)}
# (copy, system scope): every copy at the GPU's scope (the ranks of one
# card), and the full one at the system's too (ranks on separate cards)
RUNS = {**{name: (name, 0) for name in VARIANTS}, "full_sys": ("full", 1)}
ROWS, S_LOCAL, HALO, NFFT = 13 * 332, 1455, 699, 4096


def _sources(src: str) -> dict:
    for old, _ in CUTS.values():
        if src.count(old) != 1:
            raise RuntimeError(f"the kernel no longer has the text to cut: "
                               f"{old.strip()[:60]!r}")
    out = {}
    for name, cuts in VARIANTS.items():
        s = src
        for c in cuts:
            s = s.replace(*CUTS[c])
        out[name] = s + PULL if name == "full" else s
    return out


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from radar_tpu_torch import _build
    from radar_tpu_torch.parallel.mesh import make_mesh
    from radar_tpu_torch.parallel.pallas_ring import HaloExchange

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ablate_ring: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    with open(os.path.join(_build._CSRC, "ring.cu")) as f:
        sources = _sources(f.read())
    out_dir = os.path.join(os.path.dirname(_build.BUILD_DIR), "ablate_ring")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, src in sources.items():
        with open(os.path.join(out_dir, f"{name}.cu"), "w") as f:
            f.write(src)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build._COMMON, "-o",
             os.path.join(out_dir, f"lib{name}.so"),
             os.path.join(out_dir, f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the {name} copy:\n{log}")
        lib = ctypes.CDLL(os.path.join(out_dir, f"lib{name}.so"))
        for fn, argtypes in _build._SIGNATURES["ring"].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.radar_error_string.argtypes = [ctypes.c_int]
        lib.radar_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    libs["full"].k6_pull.argtypes = PULL_SIGNATURE
    libs["full"].k6_pull.restype = ctypes.c_int

    mesh = make_mesh(device="cuda")
    g = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randn((ROWS, S_LOCAL), dtype=torch.complex64, generator=g,
                    device="cuda")
    dev_t = lambda e: getattr(e, "self_device_time_total",
                              getattr(e, "self_cuda_time_total", 0))

    def exchange(lib, sys_scope=0) -> HaloExchange:
        _build._libs["ring"] = lib
        ex = HaloExchange(mesh, ROWS, S_LOCAL, HALO, dtype=torch.complex64,
                          timeout_s=2.0, nfft=NFFT)
        ex._send = 1             # carry the halo, as to any rank but the first
        ex._sys_left = ex._sys_right = sys_scope
        return ex

    def kernel_ms(fn, reps: int = 20) -> dict:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        return {e.key: dev_t(e) / reps / 1e3 for e in prof.key_averages()
                if dev_t(e) > 0}

    def events_ms(fn, reps: int = 20) -> float:
        fn()
        torch.cuda.synchronize()
        ts = []
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            ts.append(a.elapsed_time(b))
        return statistics.median(ts)

    times = {name: {"push": [], "fill": []} for name in RUNS}
    for _ in range(args.rounds):
        for name, (copy, sys_scope) in RUNS.items():
            ex = exchange(libs[copy], sys_scope=sys_scope)
            ms = kernel_ms(lambda: ex.overlap_save_input(x))
            ex.close()
            for part in ("push", "fill"):
                times[name][part].append(sum(
                    v for k, v in ms.items() if f"{part}_kernel" in k))

    full = libs["full"]
    ex = exchange(full)
    ex_old = exchange(full)
    pad = NFFT - HALO - S_LOCAL

    def old_build():
        ex_old.push(x)
        ex_old._pushed = False
        halo = torch.empty((ROWS, HALO), dtype=x.dtype, device=x.device)
        _build.check(full, full.k6_pull(
            ex_old._base, ex_old._slot, NFFT * 8, ROWS, HALO * 8,
            halo.data_ptr(), ex_old._seq, ex_old.timeout_ns, ex_old._status,
            ex_old._blocks, ex_old._stream), "k6_pull")
        return torch.nn.functional.pad(torch.cat([halo, x], -1), (0, pad))

    new_ms = kernel_ms(lambda: ex.overlap_save_input(x))
    old_ms = kernel_ms(old_build)
    src = x[:, S_LOCAL - HALO:]
    flat_src = src.contiguous()
    flat_dst = torch.empty_like(flat_src)
    slot = ex.peer_slot_view()
    res = {
        "card": card, "shape": [ROWS, S_LOCAL, HALO, 8, NFFT],
        "kernel_ms": {name: {part: statistics.median(v)
                             for part, v in parts.items()}
                      for name, parts in times.items()},
        "rounds": times,
        "exchange_events_ms": events_ms(lambda: ex.overlap_save_input(x)),
        "fft_input_build_ms": {"push_fill": sum(new_ms.values()),
                               "push_pull_cat_pad": sum(old_ms.values())},
        "fft_input_build_kernels": {"push_fill": new_ms,
                                    "push_pull_cat_pad": old_ms},
        "copy_contiguous_ms": sum(kernel_ms(
            lambda: flat_dst.copy_(flat_src)).values()),
        "copy_into_slot_ms": sum(kernel_ms(lambda: slot.copy_(src)).values()),
    }
    ex.close()
    ex_old.close()
    _build._libs.pop("ring")
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
