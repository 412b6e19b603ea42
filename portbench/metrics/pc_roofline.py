"""pc_roofline: the exact chain's pulse compression (``ops/
pulse_compression.py``, the ``pc`` stage of ``pipeline/frame.py::
make_frame_stages`` as the chain calls it) against its bound.

Time: CUDA events around the stage on a complex64 beam cube of the
chain's shape [P, S, B], alone on a busy card. Bound: the larger of the
three segments' direct matched filter (complex multiply-adds over every
pulse and beam) at the configuration's precision peak and the cube read
once and the gates written once at the card's bandwidth. Moves
``trials_per_s``."""

from portbench import roofline
from portbench.reference.consts import radar


def read(run):
    import torch
    from radar_tpu_torch.pipeline.frame import make_frame_stages

    if run.device.type != "cuda":
        return None
    st = make_frame_stages(run.cfg, device=run.device)
    peak = roofline.peaks(torch.cuda.get_device_name(run.device))
    if st.pc is None or peak is None:
        return None
    r = radar(run.config["radar"])
    g = torch.Generator(device=run.device)
    g.manual_seed(int(run.seed) & 0xFFFFFFFFFFFFFFFF)
    beams = torch.randn((r.num_p, r.num_s, r.num_b), dtype=torch.complex64,
                        generator=g, device=run.device)
    ms = roofline.time_ms(lambda: st.pc(beams), run.device)
    bound, which = roofline.pc_bound_s(
        r, peak, roofline.PRECISION_PEAK[run.config["precision"]])
    run.counters["pc_roofline"] = {"ms": ms, "bound_ms": bound * 1e3,
                                   "bound": which}
    return 100.0 * bound * 1e3 / ms
