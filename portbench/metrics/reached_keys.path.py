"""reached_keys.path: the groups a CTA's list reaches (``ncand``) summed /
the CTAs launched, over the culled- and global-mode ``launch`` spans of
the traced stretch, from the program's counters there: the mean list a
CTA sorts and walks."""

from portbench import progspans


def read(r):
    recs = progspans.program_records() if r.stretch is not None else None
    waves = [x for x in recs or () if x.name == "launch" and "reached_keys" in x.attrs]
    ctas = sum(x.attrs["ctas"] for x in waves)
    return sum(x.attrs["reached_keys"] for x in waves) / ctas if ctas else None
