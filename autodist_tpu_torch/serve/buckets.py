"""Bucket selection for the inference runtime.

Counterpart of ``autodist_tpu/serve/buckets.py``, with the same behaviour
and error texts. The serving engine warms up a small set of padded
*buckets* ahead of time and routes every request batch to the smallest
bucket that fits (padding the remainder).  The selection
rule lives here as a public, separately-testable helper —
:func:`pick_bucket` — shared by the server's continuous-batching queue
and by anyone doing their own request routing.
"""
from autodist_tpu_torch import const


def normalize_buckets(buckets):
    """Canonicalize a bucket list: ints become 1-tuples, every bucket must
    share one rank, entries must be positive, and the result is sorted by
    padded element count (ties broken lexicographically) so "smallest
    admissible" is a prefix scan.  Raises ``ValueError`` on an empty or
    ragged list."""
    if buckets is None:
        raise ValueError("bucket list is None")
    out = []
    for b in buckets:
        t = (int(b),) if not isinstance(b, (tuple, list)) else \
            tuple(int(x) for x in b)
        if not t or any(x < 1 for x in t):
            raise ValueError(f"bucket {b!r} must be positive and non-empty")
        out.append(t)
    if not out:
        raise ValueError("empty bucket list: the serve engine needs at "
                         "least one padded batch bucket (set "
                         "AUTODIST_SERVE_BUCKETS or pass buckets=)")
    ranks = {len(t) for t in out}
    if len(ranks) != 1:
        raise ValueError(f"buckets must share one rank, got {sorted(out)}")

    def elems(t):
        n = 1
        for x in t:
            n *= x
        return n
    return sorted(set(out), key=lambda t: (elems(t), t))


def pick_bucket(shape, buckets):
    """Smallest admissible bucket for a request of ``shape``.

    ``shape`` is an int (batch rows) or a tuple of leading dims (e.g.
    ``(rows, seq_len)``); ``buckets`` is a list of ints or same-rank
    tuples.  A bucket is admissible when every dim is >= the request's;
    among admissible buckets the one with the fewest padded elements wins
    (ties broken lexicographically, so the choice is deterministic).

    Raises ``ValueError`` on an empty bucket list or when no bucket fits
    (an oversize request must fail loudly at admission, not deep inside
    the padding code).  An exact fit returns that bucket unchanged.
    """
    want = (int(shape),) if not isinstance(shape, (tuple, list)) else \
        tuple(int(x) for x in shape)
    norm = normalize_buckets(buckets)
    if len(norm[0]) != len(want):
        raise ValueError(f"request shape {want} and buckets {norm} have "
                         f"different ranks")
    for b in norm:  # sorted smallest-first: first admissible is the answer
        if all(bd >= wd for bd, wd in zip(b, want)):
            return b
    raise ValueError(
        f"request shape {want} exceeds every bucket {norm}; add a larger "
        f"bucket or split the request")


def buckets_from_env(default=(8, 32, 128)):
    """Bucket list from ``AUTODIST_SERVE_BUCKETS`` ("8,32,128" or
    "8x128,32x128" for multi-dim buckets), else ``default``."""
    raw = const.ENV.AUTODIST_SERVE_BUCKETS.val
    if not raw:
        return normalize_buckets(default)
    out = []
    for part in raw.split(","):
        part = part.strip()
        if not part:
            continue
        dims = [p for p in part.replace("X", "x").split("x") if p]
        out.append(tuple(int(d) for d in dims) if len(dims) > 1
                   else int(dims[0]))
    return normalize_buckets(out)
