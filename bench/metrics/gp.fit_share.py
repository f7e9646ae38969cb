"""The traced window's share inside the GP's hyperparameter fits: the union
of the program's outermost `gp.fit` spans (`GP.fit`, `GPStack.fit`, the
classifiers' fits within them) over the window."""

import intervals
import program_spans


def read(record):
    fits = program_spans.outermost(program_spans.load(record), "gp.fit")
    if not fits:
        return None
    union = intervals.union([(s[1], s[2]) for s in fits])
    return 100.0 * intervals.length(union) / record["window_s"]
