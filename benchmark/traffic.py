"""The one traffic generator: a mix file's parameters to a list of requests.

A mix (`traffic/<name>.json`) is data:

    {"entry": "engine" | "engine_fresh" | "reconstruction_fresh",
     "coalitions": "all" | [[sizes of bucket 0], [sizes of bucket 1], ...],
     "per_request": "all" | n,
     "requests": n,                    # for "all": requests in the list
     "sample": n,                      # answers the check compares
     "trace": {"skip": n, "requests": n},
     "close": "batch" | "request"}       # where the window may close

With "all" every request asks for every non-empty coalition of the
configuration's partners, in powerset order (by size, then
lexicographic). With buckets, each bucket lists its coalitions of those
sizes in powerset order and is cut into requests of `per_request`; the
buckets' requests are interleaved in proportion to their counts (a
bucket's next request goes when its share of issued requests falls
behind), so every run starts from the same request and no coalition is
asked for twice. Nothing here depends on the seed.

The entries (how the program serves a request) are `entries.py`'s.
"""

from __future__ import annotations

from itertools import combinations


def powerset(partners: int, sizes) -> list:
    return [c for k in sizes for c in combinations(range(partners), k)]


def requests(mix: dict, partners: int) -> list:
    """The mix's requests, each a list of coalitions (sorted tuples)."""
    if mix["coalitions"] == "all":
        every = powerset(partners, range(1, partners + 1))
        return [list(every) for _ in range(int(mix["requests"]))]
    n = int(mix["per_request"])
    queues = []
    for sizes in mix["coalitions"]:
        coals = powerset(partners, sizes)
        queues.append([coals[i:i + n] for i in range(0, len(coals), n)])
    total = sum(len(q) for q in queues)
    issued = [0] * len(queues)
    out = []
    for _ in range(total):
        # the bucket furthest behind its share of the requests issued so far
        b = min((i for i in range(len(queues)) if issued[i] < len(queues[i])),
                key=lambda i: (issued[i] + 1) / len(queues[i]))
        out.append(queues[b][issued[b]])
        issued[b] += 1
    return out


def warmup_requests(mix: dict, reqs: list) -> list:
    """One request of each shape the window will use: the first of each
    bucket (the "all" mixes have one shape)."""
    if mix["coalitions"] == "all":
        return reqs[:1]
    seen, out = set(), []
    for r in reqs:
        sizes = frozenset(len(c) for c in r)
        key = next((i for i, b in enumerate(mix["coalitions"]) if sizes <= set(b)), None)
        if key not in seen:
            seen.add(key)
            out.append(r)
    return out
