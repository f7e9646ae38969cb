"""The share of the window's GP hyperparameter fits that ran as one launch
of the hand-written kernel K4: the program's outermost `gp.fit` spans whose
`path` attribute is "kernel", over all of them, in percent.  None where no
fit span carries a `path` (a program that records none)."""

import program_spans


def read(record):
    fits = program_spans.outermost(program_spans.load(record), "gp.fit")
    paths = [s[4].get("path") for s in fits]
    if not paths or all(p is None for p in paths):
        return None
    return 100.0 * paths.count("kernel") / len(paths)
