"""Strict Prometheus text-exposition parser and renderer (a copy of
kubeflow_tpu/obs/exposition.py; the port imports nothing of the JAX
package).

The elastic coordinator federates its workers' `/metrics` texts
(obs/federation.py): each scrape is parsed, merged and rendered again.
The parser is pedantic where Prometheus' own is forgiving: a render bug
(a histogram without `+Inf`, an unescaped quote in a label) fails at
the first parse. `render_families` is its exact inverse: its output
parses back to an equal dict, so parse -> merge -> render chains.
"""

from __future__ import annotations

import math

# -- strict exposition parser -------------------------------------------


class ExpositionError(ValueError):
    """A violation of the exposition contract (line number included)."""


def _unescape_label_value(raw: str, lineno: int) -> str:
    out = []
    i = 0
    while i < len(raw):
        c = raw[i]
        if c == "\\":
            if i + 1 >= len(raw):
                raise ExpositionError(
                    f"line {lineno}: dangling backslash in label value")
            nxt = raw[i + 1]
            if nxt == "\\":
                out.append("\\")
            elif nxt == '"':
                out.append('"')
            elif nxt == "n":
                out.append("\n")
            else:
                raise ExpositionError(
                    f"line {lineno}: bad escape \\{nxt} in label value")
            i += 2
        else:
            out.append(c)
            i += 1
    return "".join(out)


def _parse_labels(body: str, lineno: int) -> dict[str, str]:
    """Parse the inside of `{...}` honoring escapes; quotes/commas
    inside label VALUES must not split pairs."""
    labels: dict[str, str] = {}
    i = 0
    n = len(body)
    while i < n:
        eq = body.find("=", i)
        if eq < 0:
            raise ExpositionError(f"line {lineno}: label without '='")
        name = body[i:eq].strip()
        if not name or not name.replace("_", "a").isalnum():
            raise ExpositionError(f"line {lineno}: bad label name {name!r}")
        if eq + 1 >= n or body[eq + 1] != '"':
            raise ExpositionError(
                f"line {lineno}: label value for {name} not quoted")
        j = eq + 2
        while j < n:
            if body[j] == "\\":
                j += 2
                continue
            if body[j] == '"':
                break
            j += 1
        if j >= n:
            raise ExpositionError(
                f"line {lineno}: unterminated label value for {name}")
        if name in labels:
            raise ExpositionError(f"line {lineno}: duplicate label {name}")
        labels[name] = _unescape_label_value(body[eq + 2:j], lineno)
        i = j + 1
        if i < n:
            if body[i] != ",":
                raise ExpositionError(
                    f"line {lineno}: expected ',' between labels, "
                    f"got {body[i]!r}")
            i += 1
    return labels


def _parse_value(raw: str, lineno: int) -> float:
    if raw in ("+Inf", "Inf"):
        return math.inf
    if raw == "-Inf":
        return -math.inf
    try:
        return float(raw)
    except ValueError:
        raise ExpositionError(
            f"line {lineno}: unparseable sample value {raw!r}") from None


_HISTOGRAM_SUFFIXES = ("_bucket", "_sum", "_count")


def parse_exposition(text: str) -> dict[str, dict]:
    """Parse + validate a Prometheus text exposition.

    Returns {family_name: {"type": str, "help": str, "samples":
    {(sample_name, ((label, value), ...)): float}}}. Raises
    ExpositionError on any contract violation.
    """
    families: dict[str, dict] = {}

    def family_of(sample_name: str, lineno: int) -> dict:
        if sample_name in families:
            return families[sample_name]
        for suffix in _HISTOGRAM_SUFFIXES:
            base = sample_name.removesuffix(suffix)
            if base != sample_name and base in families \
                    and families[base]["type"] == "histogram":
                return families[base]
        raise ExpositionError(
            f"line {lineno}: sample {sample_name!r} has no preceding "
            "# TYPE declaration")

    for lineno, line in enumerate(text.split("\n"), start=1):
        if not line.strip():
            continue
        if line.startswith("# HELP "):
            parts = line[len("# HELP "):].split(" ", 1)
            fam = families.setdefault(
                parts[0], {"type": None, "help": None, "samples": {}})
            fam["help"] = parts[1] if len(parts) > 1 else ""
            continue
        if line.startswith("# TYPE "):
            parts = line[len("# TYPE "):].split(" ", 1)
            if len(parts) != 2 or parts[1] not in (
                    "counter", "gauge", "histogram", "summary", "untyped"):
                raise ExpositionError(f"line {lineno}: bad TYPE line")
            fam = families.setdefault(
                parts[0], {"type": None, "help": None, "samples": {}})
            if fam["type"] is not None:
                raise ExpositionError(
                    f"line {lineno}: duplicate TYPE for {parts[0]}")
            fam["type"] = parts[1]
            continue
        if line.startswith("#"):
            continue  # comment
        # sample line: name[{labels}] value
        brace = line.find("{")
        if brace >= 0:
            close = line.rfind("}")
            if close < brace:
                raise ExpositionError(f"line {lineno}: unbalanced braces")
            name = line[:brace]
            labels = _parse_labels(line[brace + 1:close], lineno)
            rest = line[close + 1:].strip()
        else:
            name, _, rest = line.partition(" ")
            labels = {}
            rest = rest.strip()
        if not name or not rest or " " in rest:
            raise ExpositionError(f"line {lineno}: malformed sample line")
        fam = family_of(name, lineno)
        if fam["type"] is None:
            raise ExpositionError(
                f"line {lineno}: sample {name!r} precedes its TYPE")
        key = (name, tuple(sorted(labels.items())))
        if key in fam["samples"]:
            raise ExpositionError(
                f"line {lineno}: duplicate series {name}{labels}")
        fam["samples"][key] = _parse_value(rest, lineno)

    for fname, fam in families.items():
        if fam["type"] is None:
            raise ExpositionError(f"family {fname}: HELP without TYPE")
        if fam["help"] is None:
            raise ExpositionError(f"family {fname}: TYPE without HELP")
        if not fam["samples"]:
            continue
        if fam["type"] == "counter":
            for (sname, labels), v in fam["samples"].items():
                if v < 0:
                    raise ExpositionError(
                        f"counter {sname}{dict(labels)} is negative ({v})")
        if fam["type"] == "histogram":
            _check_histogram(fname, fam)
    return families


def _check_histogram(fname: str, fam: dict) -> None:
    """Cumulative nondecreasing buckets, +Inf == _count, _sum present —
    per label-set (le excluded)."""
    by_labelset: dict[tuple, dict] = {}
    for (sname, labels), v in fam["samples"].items():
        ldict = dict(labels)
        le = ldict.pop("le", None)
        group = by_labelset.setdefault(
            tuple(sorted(ldict.items())),
            {"buckets": [], "sum": None, "count": None})
        if sname == fname + "_bucket":
            if le is None:
                raise ExpositionError(f"{sname}: bucket without le label")
            group["buckets"].append((_parse_value(le, 0), v))
        elif sname == fname + "_sum":
            group["sum"] = v
        elif sname == fname + "_count":
            group["count"] = v
        else:
            raise ExpositionError(
                f"{sname}: unexpected sample in histogram {fname}")
    for labelset, group in by_labelset.items():
        where = f"histogram {fname}{dict(labelset)}"
        if group["sum"] is None or group["count"] is None:
            raise ExpositionError(f"{where}: missing _sum or _count")
        if not group["buckets"]:
            raise ExpositionError(f"{where}: no buckets")
        les = [le for le, _ in group["buckets"]]
        if les != sorted(les):
            raise ExpositionError(f"{where}: buckets not in le order")
        if len(set(les)) != len(les):
            raise ExpositionError(f"{where}: duplicate le buckets")
        counts = [c for _, c in group["buckets"]]
        if any(b > a for b, a in zip(counts, counts[1:])):
            raise ExpositionError(f"{where}: bucket counts not cumulative")
        if les[-1] != math.inf:
            raise ExpositionError(f"{where}: last bucket is not +Inf")
        if counts[-1] != group["count"]:
            raise ExpositionError(
                f"{where}: +Inf bucket {counts[-1]} != _count "
                f"{group['count']}")


# -- renderer: the parser's inverse -------------------------------------


def _escape_label_value(v: str) -> str:
    # the exposition escapes, as obs/metrics.py renders them
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_value(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _fmt_sample(name: str, labels: tuple, value: float) -> str:
    if labels:
        body = ",".join(
            f'{k}="{_escape_label_value(v)}"' for k, v in labels)
        return f"{name}{{{body}}} {_fmt_value(value)}"
    return f"{name} {_fmt_value(value)}"


def render_families(families: dict[str, dict]) -> str:
    """Render a `parse_exposition`-shaped dict back to exposition text.

    The output re-parses to an equal dict: HELP/TYPE always emitted,
    histogram buckets grouped per label-set in ascending `le` order
    followed by `_sum`/`_count`, everything else sorted by (sample
    name, labels) for deterministic diffs.
    """
    lines: list[str] = []
    for fname in sorted(families):
        fam = families[fname]
        lines.append(f"# HELP {fname} {fam.get('help') or fname}")
        lines.append(f"# TYPE {fname} {fam['type']}")
        samples = fam["samples"]
        if fam["type"] != "histogram":
            for (sname, labels) in sorted(samples):
                lines.append(_fmt_sample(sname, labels,
                                         samples[(sname, labels)]))
            continue
        # Histogram: per label-set (le excluded) emit buckets ascending,
        # then _sum and _count — the order _check_histogram demands.
        groups: dict[tuple, dict] = {}
        for (sname, labels), v in samples.items():
            ldict = dict(labels)
            le = ldict.pop("le", None)
            g = groups.setdefault(tuple(sorted(ldict.items())),
                                  {"buckets": [], "sum": 0.0, "count": 0.0})
            if sname == fname + "_bucket":
                g["buckets"].append((_parse_value(le, 0), v))
            elif sname == fname + "_sum":
                g["sum"] = v
            elif sname == fname + "_count":
                g["count"] = v
        for labelset in sorted(groups):
            g = groups[labelset]
            for le, v in sorted(g["buckets"]):
                blabels = tuple(sorted(
                    dict(labelset, le="+Inf" if le == math.inf
                         else _fmt_value(le)).items()))
                lines.append(_fmt_sample(fname + "_bucket", blabels, v))
            lines.append(_fmt_sample(fname + "_sum", labelset, g["sum"]))
            lines.append(_fmt_sample(fname + "_count", labelset,
                                     g["count"]))
    return "\n".join(lines) + "\n"
