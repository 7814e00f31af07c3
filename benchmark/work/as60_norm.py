"""Least work of one HK step of the separable AS model as
`examples/as_model/semi_norm.json` runs it: the counts of `work/as60.py`
(the norm's own work is `work/pair_norm.py`)."""

from work.as60 import step  # noqa: F401
