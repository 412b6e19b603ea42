"""Typed configuration tree of the PyTorch port — a copy of
``radar_tpu/config/params.py`` with identical field names and defaults, so
a config built for one package describes the same radar in the other.
(Importing ``radar_tpu.config.params`` would load JAX through
``radar_tpu/__init__.py``.) Flags that name TPU/XLA variants are kept so
configs stay interchangeable; the port refuses the ones it does not run
(``pipeline/frame.py``).

Replaces the copy-pasted MATLAB struct blocks of the reference drivers
(``config.Sig_Config`` at main_simulate_echoes_with_array_v8_3.m:68-84,
``cfar_params`` at :45-50, ``cluster_params`` at :52-54, ``config.scan`` at
:24-25, ``config.inter_frame_cluster`` at :57-65) with frozen dataclasses and
a single derived-constant computation path (SURVEY.md section 5.6).

All fields are static Python scalars so a config hashes cleanly as a jit
static argument; per-frame array state (targets, noise keys) lives elsewhere.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class SigConfig:
    """Radar signal constants (reference ``config.Sig_Config``, v8_3:68-84)."""

    c: float = 2.99792458e8
    fs: float = 25e6
    fc: float = 9450e6
    prt_num: int = 332            # pulses per CPI/frame
    prt: float = 232.76e-6        # pulse repetition interval (s)
    bandwidth: float = 20e6
    # pulse widths: (narrow simple, medium LFM, long LFM) seconds
    tau: Tuple[float, float, float] = (0.16e-6, 8e-6, 28e-6)
    # gaps after narrow / medium pulses (third value unused in waveform
    # placement; it is the remainder of the PRT) — v8_3:75
    gap_duration: Tuple[float, float, float] = (11.4e-6, 31.8e-6, 153.4e-6)
    # range-gate counts of the three spliced PC segments — v8_3:76
    point_prt_segments: Tuple[int, int, int] = (228, 723, 2453)
    channel_num: int = 16
    beam_num: int = 13

    @property
    def wavelength(self) -> float:
        return self.c / self.fc

    @property
    def ts(self) -> float:
        return 1.0 / self.fs

    @property
    def point_prt(self) -> int:
        """Samples per PRT (5819 for the default config) — v8_3:82."""
        return round(self.prt * self.fs)

    @property
    def n_total_gate(self) -> int:
        """Total spliced range gates (3404 default) — v8_3:84."""
        return sum(self.point_prt_segments)

    @property
    def v_max(self) -> float:
        """Unambiguous velocity span, lambda/(2*PRT) — v8_3:173."""
        return self.wavelength / (2.0 * self.prt)

    @property
    def frame_time(self) -> float:
        return self.prt_num * self.prt


@dataclasses.dataclass(frozen=True)
class ArrayConfig:
    """Array geometry (reference ``config.Array``, v8_3:79)."""

    element_spacing: float = 0.0138  # meters
    # Number of physical elements; equals SigConfig.channel_num in the
    # reference (16) but scalable to 64/128 here.
    num_elements: int = 16


@dataclasses.dataclass(frozen=True)
class ScanConfig:
    """Servo azimuth scan (reference ``config.scan``, v8_3:24-25)."""

    rpm: float = 6.0
    start_azimuth_deg: float = 0.0

    @property
    def deg_per_sec(self) -> float:
        return self.rpm * 6.0

    def deg_per_frame(self, sig: SigConfig) -> float:
        return self.deg_per_sec * sig.frame_time


@dataclasses.dataclass(frozen=True)
class CfarParams:
    """2D GOCA-CFAR parameters (reference ``cfar_params``, v8_3:45-50)."""

    ref_cells_v: int = 5
    guard_cells_v: int = 10
    ref_cells_r: int = 5
    guard_cells_r: int = 10
    threshold_factor: float = 8.0
    method: str = "GOCA"  # one of GOCA | CA | SO (per-dim combine rule)
    # Fixed detection capacity for jit-static shapes (SURVEY.md section 7.4);
    # on a card the clusterings' kernel takes at most 1024
    # (cluster/connected.py::MAX_SLOTS)
    max_detections: int = 512
    # Window-mean formulation for the RANGE axis (the 3404-gate axis, where
    # the work is): "shift" = statically-unrolled VPU shift-adds, exactly
    # the oracle's fp order (cell-exact tests); "matmul" = blocked
    # banded-stencil MXU matmul (the ops/pulse_compression.py trick applied
    # to the box filters) — same means up to f32 summation order (~1 ULP),
    # so individual mask cells sitting within float rounding of the
    # threshold may flip; Pfa is re-validated for this variant in
    # results/pfa_calibration.json. The short Doppler axis always uses
    # shift-adds.
    means_impl: str = "shift"


@dataclasses.dataclass(frozen=True)
class Cfar1DParams:
    """Real-data-style segmented 1D CA-GO/SO CFAR
    (debug_simulated_data_processing_v2.m:419-558; SURVEY.md section 2.1
    "CFAR detector (real-data style)")."""

    ref_cells: int = 16
    guard_cells: int = 4
    threshold_factor: float = 8.0
    method: str = "GO"  # GO | SO | CA
    # zero-velocity clutter suppression half-width, in m/s
    mtd_zero_vel_ms: float = 3.0


@dataclasses.dataclass(frozen=True)
class ClusterParams:
    """Intra/inter-beam clustering gates (reference ``cluster_params``,
    v8_3:52-54)."""

    max_range_sep: float = 30.0   # meters
    max_vel_sep: float = 0.4      # m/s
    max_angle_sep: float = 5.0    # degrees (stage 1 only)
    max_clusters: int = 128       # jit-static capacity
    # Stage-2 (inter-beam anti-ghost) velocity gate override. The
    # reference reuses max_vel_sep=0.4 m/s for BOTH stages
    # (fun_process_single_frame.m:361); tracking-MC diagnosis
    # (results/tracking_mc.json ghost_tracks): elevation-sidelobe ghosts
    # of an edge-of-fan target slip the merge when their velocity
    # estimate differs by >0.4 m/s from the main lobe's, surviving as
    # false tracks. Setting e.g. 1.0 widens ONLY the anti-ghost merge
    # (cross-beam, same range) without touching stage-1 target
    # separation. None = reference behavior (default).
    stage2_vel_gate: float | None = None
    # v7_7 variant: stage 1 keeps the modal member PairIndex per cluster
    # (mode([detections.PairIndex]), main_simulate_echoes_with_array_
    # v7_7.m:766 — MATLAB mode tie-breaks to the smallest value); stage 2
    # carries the winner's. The v8 path drops the pair index (default).
    keep_pair_mode: bool = False


@dataclasses.dataclass(frozen=True)
class InterFrameParams:
    """Inter-frame 5D track association (reference
    ``config.inter_frame_cluster``, v8_3:57-65)."""

    enable: bool = True
    k: float = 1.0
    gate_az_deg: float = 10.0
    max_frame_gap: int = 3
    max_tracks: int = 256
    # The reference gates azimuth with a PLAIN |az_i - az_j| on values
    # wrapped mod 360 and merges with a linear power-weighted mean
    # (v8_3.m:288,323) — a physical track crossing north (359.9 -> 0.1
    # deg) splits into two tracks and a straddling cluster's merged
    # azimuth lands near 180. False (default) preserves that reference
    # behavior; True uses the circular distance min(|d|, 360-|d|) and a
    # power-weighted circular mean (atan2 of summed sin/cos) instead.
    wrap_azimuth: bool = False

    def gate_r(self, cluster: ClusterParams) -> float:
        return cluster.max_range_sep * self.k

    def gate_v(self, cluster: ClusterParams) -> float:
        return cluster.max_vel_sep * self.k

    def gate_el(self, cluster: ClusterParams) -> float:
        return cluster.max_angle_sep * self.k


@dataclasses.dataclass(frozen=True)
class InterpParams:
    """Spline peak-refinement parameters (reference
    fun_process_single_frame.m:237)."""

    extra_dots: int = 2
    r_interp_times: int = 8
    v_interp_times: int = 4


@dataclasses.dataclass(frozen=True)
class CorrectedAngles:
    """Site-calibration offsets of the real-data path
    (main_test_with_simulated_data.m:19-22,72-73)."""

    north_deg: float = -242.0
    fix_angle_deg: float = 35.0
    elevation_setting_deg: float = -10.3


@dataclasses.dataclass(frozen=True)
class ShardingParams:
    """Device-mesh layout for the distributed pipeline (no reference
    counterpart — SURVEY.md section 2.3)."""

    channel_shards: int = 1
    cpi_shards: int = 1
    range_shards: int = 1
    data_shards: int = 1  # Monte-Carlo / frame batch axis


@dataclasses.dataclass(frozen=True)
class RadarConfig:
    """Root config tree."""

    sig: SigConfig = SigConfig()
    array: ArrayConfig = ArrayConfig()
    scan: ScanConfig = ScanConfig()
    cfar: CfarParams = CfarParams()
    cfar1d: Cfar1DParams = Cfar1DParams()
    cluster: ClusterParams = ClusterParams()
    inter_frame: InterFrameParams = InterFrameParams()
    interp: InterpParams = InterpParams()
    corrected: CorrectedAngles = CorrectedAngles()
    sharding: ShardingParams = ShardingParams()
    # DBF convention: "v8" = x @ W^H (fun_process_single_frame.m:95);
    # "v7_7" = x @ fliplr(W).T (main_simulate_echoes_with_array_v7_7.m:341)
    dbf_variant: str = "v8"
    # MTD FFT length: None = prt_num (v8); 512 = zero-padded (v7_7:150)
    mtd_fft_len: int | None = None
    # Monopulse ratio on |RDM| (v8, fun_process_single_frame.m:282-285) or on
    # the complex RDM values (v7_6, main_plot_snr_vs_angle_error.m:455-458)
    monopulse_complex: bool = False
    # Evaluate the monopulse ratio at the spline-REFINED (v, r) subcell
    # position instead of the integer indices — the fix for the
    # documented reference flaw ("known flaw", fun_process_single_frame.m
    # :280-281), built per SURVEY.md section 7.1 ("optionally at refined
    # indices"). Default False: the flaw is the shipped reference
    # behavior; the A/B accuracy delta is measured in
    # results/monopulse_refined_ab.json.
    monopulse_refined: bool = False
    # Sliding-CPI window slices per frame for the two-frame real-data MTD
    # (main_test_with_simulated_data.m:80 config.mtd.win_size; see
    # pipeline/stages.stage2_mtd_windowed)
    mtd_win_size: int = 4
    # MTD backend: "matmul" (constant DFT matrix with window+fftshift
    # folded, MXU) or "fft"
    mtd_method: str = "matmul"
    # Pulse-compression backend: "matmul" (banded-Toeplitz MXU matmuls,
    # exact direct convolution, fastest on TPU) or "fft" (frequency-domain
    # fast convolution, the reference's formulation)
    pc_method: str = "matmul"
    # pallas_prng + lowrank only: the fused kernel ALSO emits the
    # adjacent-beam sum maps from its resident f32 tiles ([pairs, V, G]),
    # removing the pair_sum_maps pass and its full-RDM read; the detection
    # tail runs on the qvg layout (only the bool mask is relaid to the
    # reference scan order). sqrt(re^2+im^2) vs abs(complex): ULP-level.
    kernel_maps: bool = False
    # Run the 2D GOCA-CFAR as a standalone Pallas kernel over qvg pair-sum
    # maps (ops/pallas_kernels.py::goca_cfar_qvg_pallas): the kernel reads
    # each map cell ~1.5x and writes only the 1-byte mask + the
    # extraction's row counts, vs XLA's halo-amplified fused-loop re-reads;
    # the detection tail runs the qvg layout. Detections bit-identical to
    # the jnp formulation (same fp add order). Takes precedence over
    # tail_from_rdm. TPU only (interpret-mode on CPU is for tests, not
    # speed).
    use_pallas_cfar: bool = False
    # AWGN backend: "threefry" (jax.random, bit-reproducible across
    # backends, measured fastest on v5e) or "pallas" (fused on-core
    # hardware-PRNG kernel, ops/pallas_noise.py; TPU only)
    noise_impl: str = "threefry"
    # PRNG family for the beam-space/white noise draws: "threefry"
    # (bit-reproducible everywhere) or "rbg" (XLA RngBitGenerator, ~1.6x
    # faster on TPU; deterministic per compiled program but not guaranteed
    # stable across compiler versions)
    noise_prng: str = "threefry"
    # Distribution of the white noise driving the Pallas noise-RDM path:
    # "normal" (exact CN(0,1), erfinv transform) or "uniform" (zero-mean
    # unit-variance uniform rails straight from PRNG bits, no erfinv —
    # measured 0.36 ms/frame cheaper on v5e). Every draw is contracted
    # through >= 10k weighted terms (PC window x 332 MTD pulses) before the
    # first nonlinearity, so by CLT the noise RDM is Gaussian with the SAME
    # first/second moments either way (excess kurtosis ~ -1.2/N_eff <
    # 1e-3); validated end-to-end by the SNR-sweep statistics
    # (results/snr_sweep_uniform.json). Only consulted by
    # noise_rdm_impl="pallas"; "pallas_prng" requires "uniform".
    noise_dist: str = "normal"
    # Fuse echo synthesis + DBF into beam space: the signal is contracted
    # with the DBF weights per target before the big outer product (exact
    # algebra) and AWGN is drawn directly in beam space from the Cholesky
    # factor of the DBF-output noise covariance (distribution-identical to
    # per-channel noise -> DBF, different random stream). The raw
    # [pulses, samples, channels] cube never exists. Incompatible with
    # return_intermediates taps of raw_iq.
    fused_synth_dbf: bool = False
    # Rank-K closed-form signal RDM + post-MTD noise mixing (requires
    # fused_synth_dbf): pulse compression / MTD / beam mixing all commute
    # (they contract disjoint axes), so the deterministic signal RDM is
    # computed as K outer products, PC+MTD run on UN-mixed white beam noise,
    # and the Cholesky beam mixing is applied to the RDM where the cube is
    # 35% smaller. Exact linear identity (float reassociation only).
    lowrank_rdm: bool = False
    # lowrank path only: generate white noise only for the sample windows
    # the PC plan actually reads (74% of the PRT) — distribution-exact, 26%
    # fewer PRNG draws; False preserves draw-for-draw parity with the fused
    # path (tests/test_fused.py exact-identity check)
    compact_noise: bool = True
    # Scan the CFAR mask in native [V,G,pairs] layout and argsort the hits
    # into (pair,range,velocity)-major order, instead of relaying the whole
    # cube out transposed first; identical output below capacity
    extract_native_scan: bool = False
    # Detection-index extraction: "direct" (first_k_true_vgq — (pair,gate)
    # rows of width V computed in the producer layout, no bool relayout /
    # padded copy) or "rowfetch" (padded 4096-wide rows over the
    # transposed ravel). Bit-identical outputs; direct measures 3.06 ->
    # 2.39 ms/frame e2e on v5e (results/extract_impl_ab.json) and is the
    # default; rowfetch kept as the reference formulation
    extract_impl: str = "direct"
    # Gather detection amplitudes and estimation stencils pointwise from
    # the complex RDM instead of the materialized pair-sum maps (identical
    # values: maps[v,r,q] = |rdm[v,r,q]|+|rdm[v,r,q+1]|), leaving the full
    # pair-sum cube as an input of the CFAR box filters only (XLA can fuse
    # it away). Requires extract_impl="direct"; vgq tail only.
    tail_from_rdm: bool = False
    # lowrank noise-RDM backend: "xla" (banded-Toeplitz PC + MTD matmul +
    # mix, three stages), "pallas" (ops/pallas_rdm.py fused one-pass
    # kernel with double-buffered window DMA; TPU only), or "pallas_prng"
    # (same fused kernel but the white noise is drawn INSIDE the kernel by
    # the on-core hardware PRNG, keyed per (frame, segment, beam, chunk) —
    # no white cube in HBM at all; requires noise_dist="uniform";
    # bit/statistics validation vs "pallas": results/rdm_gen.json)
    noise_rdm_impl: str = "xla"
    # Keep the detection tail in the Pallas kernel's beams-major layout
    # (lowrank+pallas path only): RDM stays [B, V, G] (no transposed
    # complex copy out of the kernel) and the pair-sum maps / CFAR mask are
    # [pairs, G, V], whose native ravel IS the reference's
    # (pair, range, velocity)-major detection order — the 13.6M-bool
    # relayout in extract_detections disappears too. Identical detections
    # (same arithmetic, same order) as the reference layout.
    beams_major_tail: bool = False
    # bf16 output planes for the SIGNAL-FUSED noise-RDM kernel
    # (noise_rdm_impl="pallas"/"pallas_prng" with lowrank signal fusion):
    # halves the RDM write + every downstream read (pair-sum, CFAR,
    # estimation gathers) at the cost of bf16-quantizing the signal too
    # (~2^-9 relative; the noise-only kernel already shipped bf16 out
    # before signal fusion moved it to f32 planes). Measured NEUTRAL e2e
    # (1.002x, results/kernel_out_bf16_ab.json) — f32 stays the default:
    # strictly more accurate at zero measured cost. Estimation stays f32
    # (upcast hardening in measure/estimate.py).
    kernel_out_bf16: bool = False
    # Precision of the heavy constant matmuls (MTD DFT, banded-Toeplitz PC):
    # "f32" = complex64 throughout; "bf16" = bf16 multiply planes with f32
    # accumulation (~2x MXU rate, ~2^-9 input quantization; ops/precision.py)
    matmul_precision: str = "f32"

    def replace(self, **kw) -> "RadarConfig":
        return dataclasses.replace(self, **kw)


def small_test_config(
    channels: int = 8,
    pulses: int = 32,
    beams: int | None = None,
    max_detections: int = 128,
) -> RadarConfig:
    """CPU-checkable shrunk config (BASELINE.json config 1: single target,
    8-element array, 32 pulses). Keeps the waveform timing identical but
    shrinks channels/pulses/beams so every stage runs fast under jit on CPU.
    """
    sig = SigConfig(prt_num=pulses, channel_num=channels,
                    beam_num=beams if beams is not None else channels - 3)
    return RadarConfig(
        sig=sig,
        array=ArrayConfig(num_elements=channels),
        cfar=CfarParams(ref_cells_v=3, guard_cells_v=4, ref_cells_r=5,
                        guard_cells_r=10, max_detections=max_detections),
    )


def full_config() -> RadarConfig:
    """The reference's full problem size: 332 pulses x 5819 samples x 16
    channels -> 332 x 3404 x 13 RDMs (v8_3:71-84)."""
    return RadarConfig()


# The flagship perf configuration (bench.py / __graft_entry__ / --perf
# CLIs): fused beam-space synthesis, rank-K closed-form signal RDM with
# post-MTD noise mixing, bf16 MXU matmuls, rbg PRNG, fused Pallas noise-RDM
# kernel driven by uniform white rails. Every entry is statistically
# validated in results/ (see ARCHITECTURE.md "perf-path algebra").
PERF_OVERRIDES = dict(fused_synth_dbf=True, lowrank_rdm=True,
                      matmul_precision="bf16", noise_prng="rbg",
                      noise_rdm_impl="pallas_prng", noise_dist="uniform")


def perf_config(base: RadarConfig | None = None,
                pallas: bool = True) -> RadarConfig:
    """full_config() (or ``base``) with the perf-path overrides applied.

    ``pallas=False`` keeps the XLA lowrank chain instead of the fused
    Pallas kernel — the right choice on CPU, where the kernel only runs in
    (slow) interpret mode."""
    kw = dict(PERF_OVERRIDES)
    if not pallas:
        del kw["noise_rdm_impl"], kw["noise_dist"]
    return (base if base is not None else full_config()).replace(**kw)


def scaled_config(channels: int = 64, pulses: int = 256) -> RadarConfig:
    """BASELINE.json config 3: 64-element x 256-pulse frames."""
    sig = SigConfig(prt_num=pulses, channel_num=channels, beam_num=13)
    return RadarConfig(sig=sig, array=ArrayConfig(num_elements=channels))
