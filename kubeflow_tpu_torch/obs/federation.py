"""Metrics federation: merge N replica expositions into one (a copy of
kubeflow_tpu/obs/federation.py; the port imports nothing of the JAX
package).

The elastic coordinator merges its own registry's text and every live
worker's latest heartbeat exposition into `/elastic/metrics`, so one
scrape answers for the whole trainer fleet. This module is the sans-io
math: it takes exposition TEXTS keyed by replica id and returns one
merged exposition that round-trips through the strict parser
(`obs.exposition`).

Merge rules, per family across replicas:

- **counters** are summed per (sample name, labels) — fleet totals.
- **gauges** are summed too: every fleet gauge we export is an amount
  (replicas per state, goodput seconds, tokens/s), where the fleet
  value IS the sum. Info-style gauges (`serving_attention_impl`) sum
  into a replica count per value.
- **histograms** are merged on the UNION of bucket boundaries. A
  replica that lacks a boundary `u` contributes its cumulative count at
  its largest own `le <= u` (cumulative counts are nondecreasing step
  functions, so this floor interpolation is exact when grids match and
  conservative when they do not). `_sum`/`_count` add. The result
  preserves every histogram invariant the parser checks.
- a family TYPE disagreement across replicas is an `ExpositionError` —
  a fleet where two replicas disagree about what a name means is a
  deploy bug worth failing the scrape over.

A `fleet_federation_up{replica=...}` gauge (1 scraped, 0 unreachable or
unparseable) is appended so the merged document itself says which
replicas it covers; the `replica` values pass through a
`cardinality.LabelGuard` so a churning fleet cannot grow the label set
without bound.
"""

from __future__ import annotations

import math

from .cardinality import LabelGuard
from .exposition import (ExpositionError, _fmt_value, parse_exposition,
                         render_families)

__all__ = ["ExpositionError", "federate", "merge_families"]


def _merge_histogram(fname: str, variants: list[dict]) -> dict:
    """Merge histogram families on the union of bucket grids."""
    # per label-set (le excluded): list of (le->cum dict, sum, count)
    groups: dict[tuple, list[dict]] = {}
    for fam in variants:
        per_ls: dict[tuple, dict] = {}
        for (sname, labels), v in fam["samples"].items():
            ldict = dict(labels)
            le = ldict.pop("le", None)
            g = per_ls.setdefault(
                tuple(sorted(ldict.items())),
                {"cum": {}, "sum": 0.0, "count": 0.0})
            if sname == fname + "_bucket":
                g["cum"][float(le) if le not in ("+Inf", "Inf")
                         else math.inf] = v
            elif sname == fname + "_sum":
                g["sum"] = v
            elif sname == fname + "_count":
                g["count"] = v
        for ls, g in per_ls.items():
            groups.setdefault(ls, []).append(g)

    samples: dict[tuple, float] = {}
    for ls, parts in groups.items():
        grid = sorted({le for g in parts for le in g["cum"]})
        for u in grid:
            total = 0.0
            for g in parts:
                # floor interpolation: cumulative count at the largest
                # own boundary <= u (0 below the first boundary)
                own = [le for le in g["cum"] if le <= u]
                if own:
                    total += g["cum"][max(own)]
            blabels = tuple(sorted(
                dict(ls, le=_fmt_value(u)).items()))
            samples[(fname + "_bucket", blabels)] = total
        samples[(fname + "_sum", ls)] = sum(g["sum"] for g in parts)
        samples[(fname + "_count", ls)] = sum(g["count"] for g in parts)
    return samples


def merge_families(expositions: list[dict[str, dict]]) -> dict[str, dict]:
    """Merge parsed expositions (see `parse_exposition`) into one dict
    of the same shape. Raises ExpositionError on TYPE conflicts."""
    merged: dict[str, dict] = {}
    variants: dict[str, list[dict]] = {}
    for families in expositions:
        for fname, fam in families.items():
            if fname in merged:
                if merged[fname]["type"] != fam["type"]:
                    raise ExpositionError(
                        f"family {fname}: TYPE conflict across replicas "
                        f"({merged[fname]['type']} vs {fam['type']})")
            else:
                merged[fname] = {"type": fam["type"],
                                 "help": fam["help"], "samples": {}}
            variants.setdefault(fname, []).append(fam)
    for fname, fams in variants.items():
        if merged[fname]["type"] == "histogram":
            merged[fname]["samples"] = _merge_histogram(fname, fams)
            continue
        out = merged[fname]["samples"]
        for fam in fams:
            for key, v in fam["samples"].items():
                out[key] = out.get(key, 0.0) + v
    return merged


def federate(scrapes: dict[str, str | None],
             guard: LabelGuard | None = None,
             versions: dict[str, str] | None = None,
             version_guard: LabelGuard | None = None) -> str:
    """Scrape texts keyed by replica id (None = unreachable) -> one
    merged exposition text. Replicas whose text fails the strict parse
    are treated as down rather than poisoning the merge. `versions`
    (replica id -> model-version label) adds PARALLEL
    `fleet_federation_up{replica,version}` series beside the plain
    `{replica}` ones — same family, unlabeled-by-version totals
    untouched — so one federated scrape says which
    weights each covered replica was serving; values pass
    `version_guard` (capped) before becoming labels."""
    guard = guard or LabelGuard()
    versions = versions or {}
    version_guard = version_guard or LabelGuard()
    parsed: list[dict[str, dict]] = []
    up: dict[str, float] = {}
    for rid, text in scrapes.items():
        label = guard.admit(rid)
        if text is None:
            up[label] = min(up.get(label, 0.0), 0.0)
            continue
        try:
            parsed.append(parse_exposition(text))
        except ExpositionError:
            up[label] = min(up.get(label, 0.0), 0.0)
            continue
        up[label] = max(up.get(label, 1.0), 1.0)
    merged = merge_families(parsed)
    samples = {
        ("fleet_federation_up", (("replica", label),)): v
        for label, v in up.items()
    }
    # version-labelled parallel series (never replaces the plain ones)
    ver_by_label = {guard.admit(rid): v
                    for rid, v in versions.items() if v}
    for label, v in up.items():
        ver = ver_by_label.get(label)
        if ver:
            key = ("fleet_federation_up",
                   tuple(sorted((("replica", label),
                                 ("version",
                                  version_guard.admit(ver))))))
            samples[key] = max(samples.get(key, 0.0), v)
    merged["fleet_federation_up"] = {
        "type": "gauge",
        "help": "1 if the replica's /metrics was scraped and strictly "
                "parsed into this federation, 0 otherwise; "
                "version-labelled series say which model version the "
                "covered replica was serving",
        "samples": samples,
    }
    return render_families(merged)
