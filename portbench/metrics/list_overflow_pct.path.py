"""list_overflow_pct.path: 100 x the CTAs that overflowed to a scratch row /
the CTAs launched, over the culled- and global-mode ``launch`` spans of
the traced stretch, from the program's counters there: the share of the
list phase that took the full sort in global memory."""

from portbench import progspans


def read(r):
    recs = progspans.program_records() if r.stretch is not None else None
    waves = [x for x in recs or () if x.name == "launch" and "overflow" in x.attrs]
    ctas = sum(x.attrs["ctas"] for x in waves)
    return 100.0 * sum(x.attrs["overflow"] for x in waves) / ctas if ctas else None
