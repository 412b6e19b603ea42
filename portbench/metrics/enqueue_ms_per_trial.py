"""enqueue_ms_per_trial: the sweep driver's host time a trial.

The host clock from a batch's call of the trial function
(``pipeline/montecarlo.py::make_trial_fn``) to its return, before the
batch's copy to the host, summed over the window's batches outside the
profiled ones and divided by their trials. Moves ``trials_per_s`` where
the host paces the card."""


def read(run):
    spans = run.spans.get("enqueue")
    if not spans:
        return None
    return 1e3 * sum(s for s, _ in spans) / sum(n for _, n in spans)
