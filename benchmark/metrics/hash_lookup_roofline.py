"""Kernel #2 (``hash_lookup_kernel``) against the least time its work could
take, over the mean of its launches in the traced stretch.

The work comes from the counters that the program's ``hash_lookup``
wrapper counts under the profiler (``anqs_quantum_chemistry_torch/utils/
spans.py`` ``profiled_counts``: launches, queries, key words, buckets,
entries and table words, summed over the launches), and depends only on
each launch's shape, whatever implements the lookup: the bytes are the
query keys read once (4 B a key word), the bucket table read once (4 B a
table word) and each query's output written once (log|psi| and phase in
float32 and a found byte: 9 B); the operations are the bucket hash (9 (K -
1) a query over K key words) and a compare of each of the bucket's E
entries' K + 1 lanes. The least time is the longer of bytes over the card's
bandwidth and operations over its float32 rate (``peaks.json``). No table
an implementation builds for itself (the tags) is counted. A program that
counts nothing under the profiler gives no reading."""

KERNEL = "hash_lookup_kernel"


def least_seconds(counts, peak) -> float:
    """Least seconds of the launches whose counters are ``counts`` (all of
    one layout: K and E from the table's words and entries)."""
    k = counts["table_words"] / counts["entries"] - 2
    e = counts["entries"] / counts["buckets"]
    n_bytes = (4 * counts["key_words"] + 4 * counts["table_words"]
               + 9 * counts["queries"])
    ops = counts["queries"] * (9 * (k - 1) + (k + 1) * e)
    return max(n_bytes / peak["hbm_bytes_per_s"],
               ops / peak["float32_flops_per_s"])


def _counts():
    try:
        from anqs_quantum_chemistry_torch.utils.spans import profiled_counts
    except ImportError:
        return {}
    return profiled_counts()


def read(ctx):
    if ctx["trace"] is None or ctx["peak"] is None:
        return None
    counts = _counts()
    times = ctx["trace"].kernel_times(KERNEL)
    if not counts.get("launches") or not times:
        return None
    least = least_seconds(counts, ctx["peak"]) / counts["launches"]
    return 100.0 * least / (sum(times) / len(times))
