"""Validation of the noise-RDM kernel's own draws — port of
``scripts/validate_rdm_gen.py``: kernel K1 in draw mode (Philox planes
drawn by K1c inside the call) against K1 fed planes, and its statistics
against the "pallas" route's torch-drawn planes.

    python -m radar_tpu_torch.scripts.validate_rdm_gen [--cpu] [--small]
        [--out PATH]

Three checks at the perf configuration's shapes (full width, or
``--small``), at JAX's effective dtypes: the kernels' bf16 operands (the
TPU kernels' default ``mul_dtype``, which JAX's script leaves in place on
both backends) with f32 output for the first two, and the routes' own
dtypes (``pipeline/lowrank.py::route_dtypes``) for the moments:

1. bit check: K1c's exported bf16 planes fed through K1's planes mode
   equal K1 draw mode bit for bit (the same draws, the same sums);
2. rolling check: kernel K4 (``rolling=False``, every beam a block; at
   bf16 the strip GEMM with the PC's noise drawn in its producers) within
   2^-7 of max|y| of K1 (JAX's check of its window schedule; the port's
   two are equal bit for bit);
3. moments over 8 frames: mean, variance and the count of
   8-sigma cells of K1's draws against the "pallas" route's uniform and
   normal rails: the variance ratio within 2% of 1, the mean within 1e-2.

Runs on the card (``--cpu``: the plain versions on the host). Writes
``results/rdm_gen_torch.json`` (``build/`` with ``--cpu`` or ``--small``)
with the card's name and power limit and each kernel's launches.
"""

from __future__ import annotations

import argparse

from ._common import artifact_path, device_record, pick_device, write_json

FRAMES = 8          # frames of each route's moments (JAX's check's count)
# JAX's scripts/validate_rdm_gen.py passes no mul_dtype to its kernels (so
# bf16, their default, :65-72, :97-103) and out_dtype=float32
MUL_DTYPE = "bfloat16"


def _launches() -> dict:
    from ..ops import noise_rdm as nr

    return {"K1": nr.launch_count, "K1c": nr.k1c_launch_count,
            "K1c_draw": nr.k1c_draw_launch_count, "K4": nr.k4_launch_count,
            "K1_bf16": nr.k1_bf16_launch_count,
            "K1c_bf16": nr.k1c_bf16_launch_count,
            "K4_bf16": nr.k4_bf16_launch_count}


def validate(cfg, device):
    """The three checks on ``cfg``'s rank-K stages on ``device``:
    (results with each kernel's launches during them and the dtypes, K1c's
    bf16 planes, the Philox key of the bit check)."""
    import torch

    from ..ops import noise_rdm as nr
    from ..pipeline.driver import frame_seed
    from ..pipeline.lowrank import make_lowrank_stages
    from ..waveform.precompute import precompute

    pre = precompute(cfg)
    stages = {name: make_lowrank_stages(
        cfg.replace(noise_rdm_impl=impl, noise_dist=dist), pre,
        device=device) for name, impl, dist in (
            ("pallas_prng", "pallas_prng", "uniform"),
            ("pallas_uniform", "pallas", "uniform"),
            ("pallas_normal", "pallas", "normal"))}
    plan = stages["pallas_prng"].rplan
    lmat = stages["pallas_prng"].l_factor
    num_b = lmat.shape[0]
    seed = nr.seed_words(frame_seed(12345, 1))
    mul = getattr(torch, MUL_DTYPE)
    before = _launches()
    planes = nr.gen_noise_planes(plan, seed, num_b, device=device, dtype=mul)
    y_gen = nr.noise_rdm(plan, lmat, seed=seed, layout="bvg", mul_dtype=mul)
    y_dma = nr.noise_rdm(plan, lmat, planes=planes, layout="bvg",
                         mul_dtype=mul)
    y_k4 = nr.noise_rdm(plan, lmat, seed=seed, layout="bvg", rolling=False,
                        beams_per_step=num_b, mul_dtype=mul)

    def moments(noise_rdm):
        acc = torch.zeros(3, dtype=torch.float64, device=device)
        for i in range(FRAMES):
            y = noise_rdm(frame_seed(7, i), layout="bvg")
            yr = torch.view_as_real(y).double()
            var = (yr ** 2).mean()
            acc += torch.stack([yr.mean(), var,
                                (y.abs() > 8.0 * var.sqrt()).sum().double()])
        m = (acc / FRAMES).tolist()
        return {"mean": m[0], "var": m[1], "tail_count_8sigma": m[2]}

    out = {f"moments_{k}": moments(v.noise_rdm) for k, v in stages.items()}
    if device.type == "cuda":
        torch.cuda.synchronize()
    out["launches"] = {k: v - before[k] for k, v in _launches().items()}
    bit = float((y_gen - y_dma).abs().max())
    ymax = float(y_gen.abs().max())
    roll = float((y_k4 - y_gen).abs().max())
    out["bit_check"] = {"max_abs_diff": bit, "max_abs_out": ymax,
                        "pass": bit == 0.0 and ymax > 0.0}
    out["rolling_check"] = {"max_abs_diff": roll, "max_abs_out": ymax,
                            "rel": roll / ymax,
                            "pass": ymax > 0.0 and roll <= 2.0 ** -7 * ymax}
    base = out["moments_pallas_uniform"]["var"]
    out["var_ratio"] = out["moments_pallas_prng"]["var"] / base
    out["var_ratio_normal"] = out["moments_pallas_normal"]["var"] / base
    out["moments_pass"] = (abs(out["var_ratio"] - 1.0) < 0.02 and
                           abs(out["moments_pallas_prng"]["mean"]) < 1e-2)
    out["dtypes"] = {"checks_mul": MUL_DTYPE, "checks_out": "float32",
                     **{f"moments_{k}": {f: str(d).split(".")[-1] for f, d in
                                         v.dtypes._asdict().items()}
                        for k, v in stages.items()}}
    return out, planes, seed


def main(argv=None) -> dict:
    from ..config.params import full_config, perf_config, small_test_config

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain versions on the host")
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    out_path = args.out or artifact_path("rdm_gen_torch.json",
                                         args.cpu or args.small)
    device = pick_device(args.cpu)
    cfg = perf_config(small_test_config() if args.small else full_config())
    out, _, _ = validate(cfg, device)
    out["device"] = device_record(device)
    out["config"] = {"beams": cfg.sig.beam_num, "pulses": cfg.sig.prt_num,
                     "frames": FRAMES}
    write_json(out_path, out)
    for k in ("bit_check", "rolling_check", "var_ratio", "moments_pass"):
        print(k, out[k], flush=True)
    if not (out["bit_check"]["pass"] and out["rolling_check"]["pass"]
            and out["moments_pass"]):
        raise SystemExit("validate_rdm_gen: a check failed")
    return out


if __name__ == "__main__":
    main()
