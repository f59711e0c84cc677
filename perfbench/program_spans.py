"""The program's own spans (``rrmpg_tpu_torch.utils.tracing``) in a traced
window, and the arithmetic the readers of ``metrics/`` share on them.

The program records spans only while a profiler session is active, so in
a ``--trace 1`` run; their times are on ``time.time_ns``, the clock of the
trace's device events and of the window's bounds.  A program without the
tracing module, or one that recorded no span in the window, reads None.
"""

from perfbench.trace import clip, merge


def window_spans(ctx):
    """The program's spans that lie inside the traced window, or None where
    the run has no trace or the program recorded no span there."""
    if ctx.trace is None:
        return None
    try:
        from rrmpg_tpu_torch.utils import tracing
    except ImportError:
        return None
    lo, hi = ctx.trace.open_ns, ctx.trace.close_ns
    inside = [s for s in tracing.spans()
              if s["start_ns"] >= lo and s["end_ns"] <= hi]
    return inside or None


def syncs_per_call(ctx):
    """``sync`` spans of the window over its calls: the host's waits for a
    card, each read back or pageable copy once."""
    spans = window_spans(ctx)
    if spans is None or not ctx.window.calls:
        return None
    return sum(s["name"] == "sync" for s in spans) / ctx.window.calls


def _intersection(a, b):
    """Length of the overlap of two sorted unions of intervals."""
    total, i, j = 0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_in_syncs(ctx):
    """Per card, the window's idle time that falls inside a ``sync`` span
    (the host waiting on a device read or copy) over the window, averaged
    over the cards."""
    spans = window_spans(ctx)
    t = ctx.trace
    if spans is None or not t.indices:
        return None
    lo, hi = t.open_ns, t.close_ns
    syncs = merge(clip([(s["start_ns"], s["end_ns"]) for s in spans
                        if s["name"] == "sync"], lo, hi))
    if not syncs:
        return 0.0
    shares = []
    for i in t.indices:
        busy = t.busy_intervals(i)
        edges = [lo] + [x for iv in busy for x in iv] + [hi]
        idle = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
        shares.append(_intersection(idle, syncs) / (hi - lo))
    return sum(shares) / len(shares)


def host_us_per_generation(ctx):
    """Mean over the window's ``de.generation`` spans of their length less
    the ``sync`` spans inside them, in us: DE's host work a generation,
    the wrapper's and the launch's included, the waits left out."""
    spans = window_spans(ctx)
    if spans is None:
        return None
    gens = {s["id"]: s["end_ns"] - s["start_ns"] for s in spans
            if s["name"] == "de.generation"}
    if not gens:
        return 0.0
    parent = {s["id"]: s["parent"] for s in spans}
    for s in spans:
        if s["name"] != "sync":
            continue
        up = s["parent"]
        while up is not None and up not in gens:
            up = parent.get(up)
        if up is not None:
            gens[up] -= s["end_ns"] - s["start_ns"]
    return sum(gens.values()) / len(gens) / 1e3


def _card(device):
    """The card index of a span's ``device`` attribute ('cuda:1' -> 1)."""
    kind, _, index = str(device).partition(":")
    return int(index) if kind == "cuda" and index else None


def shard_start_lag_ms(ctx, kernel):
    """Per call, the latest device start of its shards' kernels less the
    earliest, in ms, averaged over the calls.  The n-th ``mesh.shard``
    span on a card is paired with the n-th launch on that card of the
    kernel whose name holds ``kernel``; None where the counts differ."""
    spans = window_spans(ctx)
    if spans is None:
        return None
    shards = [s for s in spans if s["name"] == "mesh.shard"]
    if not shards:
        return 0.0
    t = ctx.trace
    starts = {}
    for i in t.indices:
        mine = sorted((s for s in shards
                       if _card(s["attrs"].get("device")) == i),
                      key=lambda s: s["start_ns"])
        launches = sorted(s for n, s, _ in t.events[i]
                          if kernel in n and t.open_ns <= s < t.close_ns)
        if len(mine) != len(launches):
            return None
        for s, at in zip(mine, launches):
            starts.setdefault(s["root"], []).append(at)
    if sum(map(len, starts.values())) != len(shards):
        return None
    lags = [max(v) - min(v) for v in starts.values()]
    return sum(lags) / len(lags) / 1e6
