"""syncs_per_trial: the host's waits on the card a sweep trial, counted by
the program: its ``rt.sync`` spans in the traced window (each copy between
host and card, each read of a device value) over its ``rt.cfar`` spans
there (one a trial). The harness's own copy of each batch's answers is
not the program's and is not counted. Moves ``trials_per_s``."""

from portbench.spans import SYNC, counted, program_spans


def read(run):
    n = counted(run)
    return len(program_spans(run, (SYNC,))) / n if n else None
