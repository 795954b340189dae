"""output_tok_s: every generated token delivered inside the window, over the
window's seconds (host clock, token stamps on the scheduler thread)."""

from h100bench import stats


def read(run):
    return stats.tokens_in((r.times for r in run.records), run.w0, run.w1) / (run.w1 - run.w0)
