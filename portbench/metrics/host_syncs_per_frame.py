"""host_syncs_per_frame: the host's waits on the card a frame of a
multi-frame run (``pipeline/driver.py::run_multiframe`` and the frame's
tail in ``pipeline/frame.py``), counted by
``torch.cuda.set_sync_debug_mode("warn")`` over one run of the window
outside the profile. Moves ``frames_per_s``."""


def read(run):
    frames = run.counters.get("sync_frames")
    if not frames or run.device.type != "cuda":
        return None
    return run.counters["host_syncs"] / frames
