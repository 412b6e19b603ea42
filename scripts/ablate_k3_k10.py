"""K3 and K10 before and after their redesign for Hopper, and the design's
variants, on one NVIDIA GPU at full frame shapes (one JSON line).

    python3 scripts/ablate_k3_k10.py [--reps 10]

K3 (pair sum + 2D GOCA-CFAR, [13, 332, 3404] magnitudes, the full config's
window): ``old`` is the first K3 (a block per (pair, 16-row, 128-gate)
tile, plain loads with an integer division per staged element, each pair
reading both of its beam planes, one cell a thread), kept only here
(``OLD_K3``, appended to a copy of ``radar_tpu_torch/csrc/cfar.cu``);
``new`` is the port's K3 (a block walks every beam of its tile through a
ring of TMA-staged slots); ``no_walk`` is the new kernel with each pair
loading both of its beams (the lines of ``WALK`` changed in a copy of
cfar.cu). Each is held bit for bit against the plain version, then timed
in turns with CUDA events on a card kept busy by a sleep kernel (and on
an idle one), with the host's time a call and the profiler's kernel time.

K10 at bf16 (perf config, a compact white cube holding K1c's planes,
through ``noise_rdm_compact(variant="resident", mul_dtype=bf16)``):
``ring`` is the port (the resident ring PC of csrc/rdm_sm90.cu), ``strip``
routes the same PC through the strip GEMM of csrc/band_pc_sm90.cu (K7's
and K9's): whether residency pays on this card. Both are held within 3e-4
RMS of the plain version and timed in turns, with the profiler's split.

The DFT of K10 and K7 at bf16: ``wgmma`` is the port's dft_kernel
(csrc/rdm_sm90.cu), ``mma_sync`` the first bf16 DFT, mtd_gemm_tc_kernel
(synchronous scalar staging into mma.sync m16n8k16), kept only here
(``OLD_DFT``, appended to a copy of csrc/rdm_variants.cu), on the same pc
planes; both held within 3e-4 RMS of the plain product and timed in
turns.

Where K10's ring PC spends its time (``ring``): the shipped kernel and
copies of csrc/rdm_sm90.cu with one part taken out (``RING_VARIANTS``:
the DSMEM exchange, the output stores, the MMAs, the reloads of strip
stages and chunks after the first), each timed alone on each segment and
on all three at once (busy card); their outputs are wrong by design. A
copy with `globaltimer` stamps (``STAMPS``) records, for two clusters, when
each warpgroup starts a pair of tiles, ends its MMAs, has the peer's
slot free, has the peer's half, and has stored its tile (700-tap
segment); the medians of those phases over the pairs are reported.

Builds into ``build/ablate_k3_k10/``; prints the card's name and power
limit in the line. Needs the CUDA toolkit and a card; imports no JAX.
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

from ablate_k1 import _events, _load, _profile  # noqa: E402

# the first K3: one block per (pair, 16-row, 128-gate) tile, the pair sums
# staged with plain loads, one cell a thread
OLD_K3 = r"""
namespace {
constexpr int kVT = 16;       // Doppler rows per block
constexpr int kGT = 128;      // gates per block
constexpr int kThreads = 256;

struct PairSum {
  const float* a;
  const float* b;
  int num_v, num_g;
  __device__ float operator()(int v, int g) const {
    if (v < 0 || v >= num_v || g < 0 || g >= num_g) return 0.f;
    const long long k = (long long)v * num_g + g;
    return __fadd_rn(a[k], b[k]);
  }
};

template <class Source>
__device__ void stage(const Source& at, float* srow, float* scol, int v0,
                      int c0, int hr, int hv) {
  const int rw = kGT + 2 * hr;
  for (int idx = threadIdx.x; idx < kVT * rw; idx += kThreads) {
    const int i = idx / rw, j = idx - i * rw;
    srow[idx] = at(v0 + i, c0 - hr + j);
  }
  for (int idx = threadIdx.x; idx < (kVT + 2 * hv) * kGT; idx += kThreads) {
    const int i = idx / kGT, j = idx - i * kGT;
    scol[idx] = at(v0 - hv + i, c0 + j);
  }
  __syncthreads();
}

__device__ __forceinline__ float threshold(const float* srow,
                                           const float* scol, int i, int j,
                                           const Window& w, float* x) {
  const int hr = w.gr + w.rr, hv = w.gv + w.rv;
  const float* r = srow + i * (kGT + 2 * hr) + hr + j;
  float lr = 0.f, tr = 0.f, lv = 0.f, tv = 0.f;
  for (int k = w.gr + 1; k <= w.gr + w.rr; ++k) {
    lr = __fadd_rn(lr, r[-k]);
    tr = __fadd_rn(tr, r[k]);
  }
  for (int k = w.gv + 1; k <= w.gv + w.rv; ++k) {
    lv = __fadd_rn(lv, scol[(i + hv - k) * kGT + j]);
    tv = __fadd_rn(tv, scol[(i + hv + k) * kGT + j]);
  }
  const float noise_r = combine(lr, tr, w.inv_rr, w.method);
  const float noise_v = combine(lv, tv, w.inv_rv, w.method);
  *x = r[0];
  return __fmul_rn(w.factor, fmaxf(noise_r, noise_v));
}

__global__ void __launch_bounds__(kThreads)
k3_old_kernel(const float* __restrict__ mag, int num_v, int num_g, Window w,
              bool* __restrict__ mask, float* __restrict__ thr) {
  extern __shared__ float smem[];
  float* srow = smem;
  float* scol = smem + kVT * (kGT + 2 * (w.gr + w.rr));
  const int q = blockIdx.z;
  const int v0 = blockIdx.y * kVT;
  const int c0 = blockIdx.x * kGT;
  const long long plane = (long long)num_v * num_g;
  stage(PairSum{mag + q * plane, mag + (q + 1) * plane, num_v, num_g},
        srow, scol, v0, c0, w.gr + w.rr, w.gv + w.rv);
  for (int cell = threadIdx.x; cell < kVT * kGT; cell += kThreads) {
    const int i = cell / kGT, j = cell - i * kGT;
    const int v = v0 + i, g = c0 + j;
    if (v >= num_v || g >= num_g) continue;
    float x;
    const float t = threshold(srow, scol, i, j, w, &x);
    const long long o = q * plane + (long long)v * num_g + g;
    mask[o] = inside_border(v, g, num_v, num_g, w) && (x > t);
    thr[o] = t;
  }
}
}  // namespace

extern "C" int k3_cfar_old(const void* mag, int num_b, int num_v, int num_g,
                           int gr, int rr, int gv, int rv, float inv_rr,
                           float inv_rv, float factor, int method, void* mask,
                           void* thr, void* stream) {
  const Window w{gr, rr, gv, rv, inv_rr, inv_rv, factor, method};
  const int hr = gr + rr, hv = gv + rv;
  const size_t smem = ((size_t)kVT * (kGT + 2 * hr) +
                       (size_t)(kVT + 2 * hv) * kGT) * sizeof(float);
  cudaFuncSetAttribute(k3_old_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  const dim3 grid((num_g + kGT - 1) / kGT, (num_v + kVT - 1) / kVT,
                  num_b - 1);
  k3_old_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(mag), num_v, num_g, w,
      static_cast<bool*>(mask), static_cast<float*>(thr));
  return (int)cudaGetLastError();
}
"""
OLD_K3_SIGNATURE = [ctypes.c_void_p] + [ctypes.c_int] * 7 + [
    ctypes.c_float] * 3 + [ctypes.c_int] + [ctypes.c_void_p] * 3
# the beam walk, and each pair loading both of its beams instead
WALK = ("""  const int n_loads = q1 - q0 + 1;
  auto beam = [&](int k) { return q0 + k; };
  auto first = [](int q) { return q; };
""", """  const int n_loads = 2 * (q1 - q0);
  auto beam = [&](int k) { return q0 + ((k + 1) >> 1); };
  auto first = [](int q) { return 2 * q; };
""")

# the first bf16 DFT: mtd_gemm_kernel on the tensor cores through mma.sync,
# operands staged by scalar loads
OLD_DFT = r"""
namespace {
__global__ void __launch_bounds__(kThreads)
mtd_gemm_tc_kernel(const float* __restrict__ dr, const float* __restrict__ di,
                   const __nv_bfloat16* __restrict__ pcr,
                   const __nv_bfloat16* __restrict__ pci, int num_v, int num_p,
                   int num_g, __nv_bfloat16* __restrict__ mtr,
                   __nv_bfloat16* __restrict__ mti) {
  const int b = blockIdx.z;
  const int v0 = blockIdx.y * kBM;
  const int g0 = blockIdx.x * kBN;
  const long long base = (long long)b * num_p * num_g;
  TcAcc acc;
  tc_gemm(
      0, num_p,
      [&](int m, int k) {
        const long long off = (long long)(v0 + m) * num_p + k;
        return v0 + m < num_v ? make_float2(dr[off], di[off]) : make_float2(0.f, 0.f);
      },
      [&](int k, int n) {
        const long long off = base + (long long)k * num_g + g0 + n;
        return g0 + n < num_g ? make_float2(__bfloat162float(pcr[off]),
                                            __bfloat162float(pci[off]))
                              : make_float2(0.f, 0.f);
      },
      acc);
  tc_store(acc, [&](int m, int n, float cr, float ci) {
    const int v = v0 + m, g = g0 + n;
    if (v >= num_v || g >= num_g) return;
    const long long off = ((long long)b * num_v + v) * num_g + g;
    mtr[off] = __float2bfloat16_rn(cr);
    mti[off] = __float2bfloat16_rn(ci);
  });
}
}  // namespace

extern "C" int rv_mtd_tc(const void* dr, const void* di, const void* pcr,
                         const void* pci, int num_b, int num_v, int num_p,
                         int num_g, void* mtr, void* mti, void* stream) {
  const dim3 grid((num_g + kBN - 1) / kBN, (num_v + kBM - 1) / kBM, num_b);
  mtd_gemm_tc_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dr), static_cast<const float*>(di),
      static_cast<const __nv_bfloat16*>(pcr),
      static_cast<const __nv_bfloat16*>(pci), num_v, num_p, num_g,
      static_cast<__nv_bfloat16*>(mtr), static_cast<__nv_bfloat16*>(mti));
  return (int)cudaGetLastError();
}
"""
OLD_DFT_SIGNATURE = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
    ctypes.c_void_p] * 3

# copies of rdm_sm90.cu with a part of the ring PC taken out: (old, new)
# text pairs
RING_VARIANTS = {
    "no_exchange": (
        ("    if (u > 0) mbar_wait_cluster(sent(wg), (u - 1) & 1);\n"
         "    if (tid == 0) mbar_expect_tx(recv(wg), kXchgBytes);\n",
         "    if (false) {\n"),
        ("    mbar_wait(recv(wg), u & 1);\n", "    }\n"),
        ("    if (tid == 0 && u + 1 < pairs) mbar_arrive_peer(peer_sent);\n",
         "")),
    "no_store": (("    if (t < nt) {\n      // chunk k of a staged row",
                  "    if (false) {\n      // chunk k of a staged row"),),
    "no_mma": (("        wgmma_n128<1, 0>(acc, desc_k(x_t + 32 * kk), "
                "desc_k(s_t + 32 * kk));\n", ""),),
    "loads_once": (
        ("x < pairs * kt; ++x, st.next(stages))",
         "x < stages; ++x, st.next(stages))"),
        ("      mbar_wait(sfull(st.i), st.phase);\n",
         "      if (u * kt + i < stages) mbar_wait(sfull(st.i), st.phase);\n"),
        ("c < 2 * pairs + kt - 1; ++c, sl.next(slots))",
         "c < slots; ++c, sl.next(slots))"),
        ("      mbar_wait(xfull(ch.i), ch.phase);\n",
         "      if (t + i < slots) mbar_wait(xfull(ch.i), ch.phase);\n")),
}
# the stamped copy: a stamp array and its reader, and five stamps a pair
STAMP = ("if (tid == 0 && (blockIdx.x == 0 || blockIdx.x == 200)) "
         "g_stamp[(blockIdx.x ? 2048 : 0) + wg * 1024 + u * 8 + {k}] = "
         "now_ns();\n")
STAMPS = (
    ("__global__ void __cluster_dims__(2, 1, 1)",
     "__device__ unsigned long long g_stamp[4096];\n"
     "__global__ void __cluster_dims__(2, 1, 1)"),
    ("  cluster_sync();   // the peer",
     "  if (threadIdx.x == 0 && (blockIdx.x == 0 || blockIdx.x == 200)) "
     "g_stamp[(blockIdx.x ? 2048 : 0) + 1023] = now_ns();\n"
     "  cluster_sync();   // the peer"),
    ("    const int t = 2 * u + wg;\n",
     "    const int t = 2 * u + wg;\n    " + STAMP.format(k=0)),
    ("    wgmma_wait<0>();\n    fence_acc64(acc);\n    if (tid == 0) {\n"
     "      mbar_arrive(sempty(prev_stage));",
     "    wgmma_wait<0>();\n    fence_acc64(acc);\n    " + STAMP.format(k=1)
     + "    if (tid == 0) {\n      mbar_arrive(sempty(prev_stage));"),
    ("    if (u > 0) mbar_wait_cluster(sent(wg), (u - 1) & 1);\n",
     "    if (u > 0) mbar_wait_cluster(sent(wg), (u - 1) & 1);\n    "
     + STAMP.format(k=2)),
    ("    mbar_wait(recv(wg), u & 1);\n",
     "    mbar_wait(recv(wg), u & 1);\n    " + STAMP.format(k=3)),
    ("    if (tid == 0 && u + 1 < pairs) mbar_arrive_peer(peer_sent);\n",
     "    " + STAMP.format(k=4)
     + "    if (tid == 0 && u + 1 < pairs) mbar_arrive_peer(peer_sent);\n"),
    ('extern "C" {',
     'extern "C" {\nint rs_stamps(void* out) {\n  return (int)cudaMemcpyFromSymbol('
     "out, g_stamp, sizeof(g_stamp));\n}\n"),
)


def build(build_dir: str) -> dict:
    """The copies of cfar.cu (the old K3 appended; the walk off) and of
    rdm_variants.cu (the old DFT appended), each built with its source's
    flags (one nvcc each, all at once) and loaded."""
    from radar_tpu_torch import _build

    src = lambda name: open(os.path.join(_build._CSRC, name + ".cu")).read()
    cfar = src("cfar")
    if cfar.count(WALK[0]) != 1:
        raise RuntimeError("cfar.cu no longer has the text no_walk changes")
    sources = {"k3_old": (cfar + OLD_K3, "cfar"),
               "k3_no_walk": (cfar.replace(*WALK), "cfar"),
               "dft_old": (src("rdm_variants") + OLD_DFT, "rdm_variants")}
    ring = src("rdm_sm90")
    for name, cuts in list(RING_VARIANTS.items()) + [("stamps", STAMPS)]:
        text = ring
        for old, new in cuts:
            if text.count(old) != 1:
                raise RuntimeError(f"rdm_sm90.cu no longer has the text "
                                   f"{name} changes: {old[:60]!r}")
            text = text.replace(old, new, 1)
        sources[f"ring_{name}"] = (text, "rdm_sm90")
    os.makedirs(build_dir, exist_ok=True)
    procs = {}
    for name, (text, base) in sources.items():
        cu = os.path.join(build_dir, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        so = os.path.join(build_dir, f"lib{name}.so")
        procs[name] = (so, base, subprocess.Popen(
            [_build._nvcc(), *_build._COMMON, *_build._EXTRA[base], "-I",
             _build._CSRC, "-o", so, cu], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, base, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        libs[name] = _load(so, base)
    libs["k3_old"].k3_cfar_old.argtypes = OLD_K3_SIGNATURE
    libs["k3_old"].k3_cfar_old.restype = ctypes.c_int
    libs["dft_old"].rv_mtd_tc.argtypes = OLD_DFT_SIGNATURE
    libs["dft_old"].rv_mtd_tc.restype = ctypes.c_int
    libs["ring_stamps"].rs_stamps.argtypes = [ctypes.c_void_p]
    libs["ring_stamps"].rs_stamps.restype = ctypes.c_int
    return libs


def in_turns(calls: dict, reps: int) -> dict:
    """Busy-card and idle-card events and host ms a call of each of
    ``calls`` in turns (forwards, then backwards), medians."""
    import torch

    for fn in calls.values():
        fn()
    torch.cuda.synchronize()
    t = {k: {"busy": [], "idle": [], "host": []} for k in calls}
    for _ in range(reps):
        for k in list(calls) + list(calls)[::-1]:
            for mode in ("idle", "busy"):
                dev_ms, host_ms = _events(calls[k], mode == "busy")
                t[k][mode].append(dev_ms)
                if mode == "busy":
                    t[k]["host"].append(host_ms)
    return {k: {"busy_ms": statistics.median(v["busy"]),
                "idle_ms": statistics.median(v["idle"]),
                "host_ms": statistics.median(v["host"])}
            for k, v in t.items()}


def k3(libs, reps: int) -> dict:
    """The old K3, the new K3 and the new without the beam walk, on
    exponential magnitudes with strong cells."""
    import torch

    from radar_tpu_torch import _build
    from radar_tpu_torch.config.params import full_config
    from radar_tpu_torch.ops import cfar_kernel as ck

    params = full_config().cfar
    g = torch.Generator(device="cuda").manual_seed(3)
    mag = torch.empty((13, 332, 3404), device="cuda").exponential_(
        generator=g)
    mag.view(-1)[torch.randint(0, mag.numel(), (200,), generator=g,
                               device="cuda")] += 60.0
    num_b, num_v, num_g = mag.shape
    window = ck._window_args(params, num_b)[:8]

    def old():
        mask = torch.empty((num_b - 1, num_v, num_g), dtype=torch.bool,
                           device="cuda")
        thr = torch.empty((num_b - 1, num_v, num_g), device="cuda")
        lib = libs["k3_old"]
        _build.check(lib, lib.k3_cfar_old(
            mag.data_ptr(), num_b, num_v, num_g, *window, mask.data_ptr(),
            thr.data_ptr(), torch.cuda.current_stream().cuda_stream),
            "k3_cfar_old")
        return mask.permute(1, 2, 0), thr.permute(1, 2, 0)

    shipped = _build.load("cfar")

    def no_walk():
        _build._libs["cfar"] = libs["k3_no_walk"]
        try:
            return ck.goca_cfar_2d_fused(mag, params)
        finally:
            _build._libs["cfar"] = shipped

    calls = {"old": old, "new": lambda: ck.goca_cfar_2d_fused(mag, params),
             "no_walk": no_walk}
    want = ck.goca_cfar_2d_fused_plain(mag, params)
    identical = {}
    for k, fn in calls.items():
        got = fn()
        torch.cuda.synchronize()
        identical[k] = bool(torch.equal(got[0], want[0])
                            and torch.equal(got[1], want[1]))
    out = in_turns(calls, reps)
    for k, fn in calls.items():
        out[k]["identical_to_plain"] = identical[k]
        out[k]["profile_ms"] = _profile(fn, reps=10)
    out["hits"] = int(want[0].sum())
    return out


def k10(reps: int):
    """K10 at bf16 with its resident ring PC and with the strip GEMM;
    returns (the results, the plan, K1c's planes)."""
    import torch

    from radar_tpu_torch.config.params import perf_config
    from radar_tpu_torch.ops import noise_rdm as nr
    from radar_tpu_torch.pipeline.lowrank import make_lowrank_stages
    from radar_tpu_torch.waveform.precompute import precompute

    bf = torch.bfloat16
    lr = make_lowrank_stages(perf_config(), precompute(perf_config()),
                             device="cuda")
    plan, lmat = lr.rplan, lr.l_factor
    num_b = lmat.shape[0]
    planes = nr.gen_noise_planes(plan, nr.seed_words(4242), num_b,
                                 device="cuda")
    z = torch.zeros((num_b, plan.n_pulses, plan.s_compact),
                    dtype=torch.complex64, device="cuda")
    for seg, (xr, xi) in zip(plan.segments, planes):
        sl = slice(seg.pad_front, seg.pad_front + seg.r_len)
        z[:, :, seg.c0:seg.c0 + seg.r_len] = torch.complex(xr[..., sl],
                                                           xi[..., sl])
    ring = nr.ring_pc

    def through_strip(segs, rows, ld, outr, outi):
        nr.strip_pc([(xr, xi, st, j, g0) for xr, xi, st, _, j, g0 in segs],
                    rows, ld, outr=outr, outi=outi)

    def strip():
        nr.ring_pc = through_strip
        try:
            return nr.noise_rdm_compact(z, plan, lmat, variant="resident",
                                        mul_dtype=bf)
        finally:
            nr.ring_pc = ring

    calls = {"ring": lambda: nr.noise_rdm_compact(
        z, plan, lmat, variant="resident", mul_dtype=bf), "strip": strip}
    ref = nr.noise_rdm_plain(plan, lmat, nr.planes_from_compact(z, plan, bf),
                             mul_dtype=bf).permute(1, 2, 0)
    rms = float(ref.abs().pow(2).mean().sqrt())
    err = {k: float((fn() - ref).abs().pow(2).mean().sqrt()) / rms
           for k, fn in calls.items()}
    del ref
    out = in_turns(calls, reps)
    for k, fn in calls.items():
        out[k]["rms_err_over_rms"] = err[k]
        out[k]["profile_ms"] = _profile(fn)
    return out, plan, planes


def dft(libs, plan, planes, reps: int) -> dict:
    """The bf16 DFT: the port's wgmma GEMM against the first, mma.sync GEMM on
    the pc planes of K10's ring PC."""
    import torch

    from radar_tpu_torch import _build
    from radar_tpu_torch.ops import noise_rdm as nr

    bf = torch.bfloat16
    num_b, num_p = planes[0][0].shape[:2]
    num_v, num_g = plan.n_dop, plan.n_gates
    ld = -(-num_g // 8) * 8
    pcr = torch.empty((num_b, num_p, ld), dtype=bf, device="cuda")
    pci = torch.empty_like(pcr)
    segs = [(nr._rows16(xr.to(bf)), nr._rows16(xi.to(bf)), seg.strip,
             seg.taps.shape[0], seg.j_len, seg.g0)
            for seg, (xr, xi) in zip(plan.segments, planes)]
    nr.ring_pc(segs, num_b * num_p, ld, pcr, pci)
    # the old kernel reads [B, P, G] planes and D as f32 planes
    pr_g = pcr[..., :num_g].contiguous()
    pi_g = pci[..., :num_g].contiguous()
    dr, di = plan.d_planes[1]
    mt = [torch.empty((num_b, num_v, num_g), dtype=bf, device="cuda")
          for _ in range(4)]
    lib = libs["dft_old"]
    calls = {
        "wgmma": lambda: nr.dft(plan, pcr, pci, num_g, mt[0], mt[1]),
        "mma_sync": lambda: _build.check(lib, lib.rv_mtd_tc(
            dr.data_ptr(), di.data_ptr(), pr_g.data_ptr(), pi_g.data_ptr(),
            num_b, num_v, num_p, num_g, mt[2].data_ptr(), mt[3].data_ptr(),
            torch.cuda.current_stream().cuda_stream), "rv_mtd_tc")}
    for fn in calls.values():
        fn()
    pc = torch.complex(pr_g.float(), pi_g.float())
    want = nr.round_mul(torch.matmul(nr.round_mul(plan.d, bf), pc), bf)
    rms = float(want.abs().pow(2).mean().sqrt())
    err = {k: float((torch.complex(a.float(), b.float()) - want).abs()
                    .pow(2).mean().sqrt()) / rms
           for k, (a, b) in (("wgmma", mt[:2]), ("mma_sync", mt[2:]))}
    out = in_turns(calls, reps)
    for k, fn in calls.items():
        out[k]["rms_err_over_rms"] = err[k]
        out[k]["profile_ms"] = _profile(fn, reps=10)
    return out


def ring(libs, plan, planes, reps: int) -> dict:
    """K10's ring PC alone, shipped and with parts taken out, per segment
    and all three at once (busy-card events, medians), and the stamped
    copy's phases of a pair of tiles on the 700-tap segment."""
    import numpy as np
    import torch

    from radar_tpu_torch import _build
    from radar_tpu_torch.ops import noise_rdm as nr

    bf = torch.bfloat16
    num_b, num_p = planes[0][0].shape[:2]
    rows, ld = num_b * num_p, -(-plan.n_gates // 8) * 8
    pcr = torch.empty((rows, ld), dtype=bf, device="cuda")
    pci = torch.empty_like(pcr)
    segs = [(nr._rows16(xr.to(bf)), nr._rows16(xi.to(bf)), seg.strip,
             seg.taps.shape[0], seg.j_len, seg.g0)
            for seg, (xr, xi) in zip(plan.segments, planes)]
    shipped = _build.load("rdm_sm90")
    names = ["shipped", *RING_VARIANTS]
    out = {}
    try:
        for name in names:
            _build._libs["rdm_sm90"] = (shipped if name == "shipped"
                                        else libs[f"ring_{name}"])
            calls = {f"seg{i}": (lambda i=i: nr.ring_pc([segs[i]], rows, ld,
                                                         pcr, pci))
                     for i in range(len(segs))}
            calls["all"] = lambda: nr.ring_pc(segs, rows, ld, pcr, pci)
            out[name] = {k: v["busy_ms"] for k, v in
                         in_turns(calls, max(2, reps // 2)).items()}
        lib = libs["ring_stamps"]
        _build._libs["rdm_sm90"] = lib
        nr.ring_pc([segs[-1]], rows, ld, pcr, pci)
        torch.cuda.synchronize()
    finally:
        _build._libs["rdm_sm90"] = shipped
    buf = (ctypes.c_ulonglong * 4096)()
    _build.check(lib, lib.rs_stamps(ctypes.addressof(buf)), "rs_stamps")
    st = np.frombuffer(buf, dtype=np.uint64).astype(np.int64)
    phases = {"mma_us": [], "peer_slot_free_us": [], "peer_half_us": [],
              "epilogue_us": [], "to_next_pair_us": []}
    for base in (0, 2048):
        for wg in range(2):
            p = st[base + wg * 1024: base + wg * 1024 + 1016].reshape(-1, 8)
            p = p[(p[:, :5] > 0).all(1)][:, :5] / 1e3
            phases["mma_us"] += list(p[:, 1] - p[:, 0])
            phases["peer_slot_free_us"] += list(p[:, 2] - p[:, 1])
            phases["peer_half_us"] += list(p[:, 3] - p[:, 2])
            phases["epilogue_us"] += list(p[:, 4] - p[:, 3])
            phases["to_next_pair_us"] += list(p[1:, 0] - p[:-1, 4])
    out["pair_phases_700_tap"] = {k: float(np.median(v)) if v else None
                                  for k, v in phases.items()}
    return out


def main() -> int:
    import torch

    from radar_tpu_torch import _build

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ablate_k3_k10: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    _build.build_all(["cfar", "rdm_sm90", "rdm_variants", "band_pc_sm90",
                      "noise_rdm"])
    libs = build(os.path.join(os.path.dirname(_build.BUILD_DIR),
                              "ablate_k3_k10"))
    res = {"card": card, "k3": k3(libs, args.reps)}
    res["k10"], plan, planes = k10(args.reps)
    res["dft"] = dft(libs, plan, planes, args.reps)
    res["ring"] = ring(libs, plan, planes, args.reps)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
