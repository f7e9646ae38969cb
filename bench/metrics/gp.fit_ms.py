"""The mean duration of one GP hyperparameter fit (a whole stack's Adam
loop): the program's outermost `gp.fit` spans, in milliseconds."""

import program_spans


def read(record):
    fits = program_spans.outermost(program_spans.load(record), "gp.fit")
    if not fits:
        return None
    return 1e3 * sum(s[2] - s[1] for s in fits) / len(fits)
