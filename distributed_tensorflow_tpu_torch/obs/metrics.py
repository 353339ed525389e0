"""Prometheus-style metrics: counters, gauges, histograms + exposition.

Counterpart of ``distributed_tensorflow_tpu/obs/metrics.py``, the port's
own copy (the port imports nothing of the JAX package): the same classes,
the same text, so the same operations on either package's registry render
byte-identical exposition and a scrape of either package's replica reads
the same ``dttpu_*`` series (catalogued in docs/OBSERVABILITY.md).

A minimal, thread-safe, pure-stdlib registry whose ``expose()`` renders
the Prometheus text exposition format (version 0.0.4) — what a scraper
expects at ``/metrics`` (served by ``obs.http.MetricsServer``).

Metric semantics follow Prometheus conventions:

* ``Counter`` — monotonically increasing (``inc``); rates are the
  scraper's job (``rate(dttpu_steps_total[1m])``).
* ``Gauge`` — a value that goes both ways (``set``/``inc``).
* ``Histogram`` — cumulative buckets + ``_sum``/``_count`` samples, so
  quantiles are computable server-side (``histogram_quantile``).

Labels are *static per instance*: ``registry.counter(name, help,
labels={"path": "greedy"})`` — one time series per (name, labels) pair,
get-or-create so independent call sites share the series.  Dynamic
label cardinality is deliberately unsupported.

``parse_exposition`` is the inverse (used by the round-trip tests and
by anything that wants to scrape programmatically).
"""
from __future__ import annotations

import math
import re
import threading
from bisect import bisect_left
from typing import Dict, Iterable, List, Optional, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "Registry", "REGISTRY",
           "parse_exposition", "render_exposition"]

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

# Default buckets sized for step/checkpoint durations in seconds.
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0)


def _format_value(v: float) -> str:
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _format_labels(labels: Tuple[Tuple[str, str], ...]) -> str:
    if not labels:
        return ""
    inner = ",".join(
        '%s="%s"' % (k, v.replace("\\", "\\\\").replace('"', '\\"')
                     .replace("\n", "\\n"))
        for k, v in labels)
    return "{" + inner + "}"


class _Metric:
    type_name = "untyped"

    def __init__(self, name: str, help_text: str,
                 labels: Tuple[Tuple[str, str], ...]):
        self.name = name
        self.help = help_text
        self.labels = labels
        self._lock = threading.Lock()

    def samples(self) -> List[Tuple[str, Tuple[Tuple[str, str], ...], float]]:
        raise NotImplementedError


class Counter(_Metric):
    type_name = "counter"

    def __init__(self, name, help_text, labels=()):
        super().__init__(name, help_text, labels)
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up; use a Gauge")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def samples(self):
        with self._lock:
            return [(self.name, self.labels, self._value)]


class Gauge(_Metric):
    type_name = "gauge"

    def __init__(self, name, help_text, labels=()):
        super().__init__(name, help_text, labels)
        self._value = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def samples(self):
        with self._lock:
            return [(self.name, self.labels, self._value)]


class Histogram(_Metric):
    type_name = "histogram"

    def __init__(self, name, help_text, labels=(),
                 buckets: Iterable[float] = DEFAULT_BUCKETS):
        super().__init__(name, help_text, labels)
        bs = sorted(float(b) for b in buckets)
        if not bs:
            raise ValueError("histogram needs at least one bucket")
        self.buckets = tuple(bs)
        self._counts = [0] * (len(self.buckets) + 1)  # trailing +Inf
        self._sum = 0.0
        self._count = 0

    def observe(self, value: float) -> None:
        v = float(value)
        i = bisect_left(self.buckets, v)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def quantile(self, q: float) -> float:
        """Upper bucket bound holding the q-quantile (the same estimate a
        Prometheus ``histogram_quantile`` makes, minus interpolation) —
        handy for in-process reporting without a scraper."""
        if not 0.0 <= q <= 1.0:
            raise ValueError("q must be in [0, 1]")
        with self._lock:
            total = self._count
            if total == 0:
                return float("nan")
            rank = q * total
            cum = 0
            for i, c in enumerate(self._counts):
                cum += c
                if cum >= rank and c:
                    return (self.buckets[i] if i < len(self.buckets)
                            else float("inf"))
        return float("inf")

    def samples(self):
        # snapshot under the lock: a concurrent observe() between the
        # bucket walk and the _count read would render an exposition
        # where the +Inf bucket and _count disagree (torn scrape)
        with self._lock:
            counts = list(self._counts)
            total_sum, total_count = self._sum, self._count
        out = []
        cum = 0
        for i, bound in enumerate(self.buckets):
            cum += counts[i]
            out.append((self.name + "_bucket",
                        self.labels + (("le", _format_value(bound)),),
                        float(cum)))
        cum += counts[-1]
        out.append((self.name + "_bucket", self.labels + (("le", "+Inf"),),
                    float(cum)))
        out.append((self.name + "_sum", self.labels, total_sum))
        out.append((self.name + "_count", self.labels, float(total_count)))
        return out


def _freeze_labels(labels: Optional[Dict[str, str]]
                   ) -> Tuple[Tuple[str, str], ...]:
    if not labels:
        return ()
    for k in labels:
        if not _LABEL_RE.match(k):
            raise ValueError(f"invalid label name {k!r}")
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


class Registry:
    """Get-or-create metric registry with text exposition."""

    def __init__(self):
        self._lock = threading.Lock()
        # (name, labels) -> metric; name -> (type, help) for consistency
        self._metrics: Dict[Tuple[str, Tuple], _Metric] = {}
        self._families: Dict[str, Tuple[type, str]] = {}

    def _get_or_create(self, cls, name, help_text, labels, **kw) -> _Metric:
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        frozen = _freeze_labels(labels)
        key = (name, frozen)
        with self._lock:
            existing = self._metrics.get(key)
            if existing is not None:
                if not isinstance(existing, cls):
                    raise ValueError(
                        f"{name} already registered as "
                        f"{existing.type_name}, not {cls.type_name}")
                return existing
            fam = self._families.get(name)
            if fam is not None and fam[0] is not cls:
                raise ValueError(f"{name} already registered with type "
                                 f"{fam[0].__name__}")
            metric = cls(name, help_text, frozen, **kw)
            self._metrics[key] = metric
            self._families.setdefault(name, (cls, help_text))
            return metric

    def counter(self, name, help_text="", labels=None) -> Counter:
        return self._get_or_create(Counter, name, help_text, labels)

    def gauge(self, name, help_text="", labels=None) -> Gauge:
        return self._get_or_create(Gauge, name, help_text, labels)

    def histogram(self, name, help_text="", labels=None,
                  buckets: Iterable[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_create(Histogram, name, help_text, labels,
                                   buckets=buckets)

    def get(self, name: str, labels=None) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get((name, _freeze_labels(labels)))

    def expose(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        with self._lock:
            families: Dict[str, List[_Metric]] = {}
            for (name, _), metric in sorted(self._metrics.items()):
                families.setdefault(name, []).append(metric)
            meta = {name: self._families[name] for name in families}
        lines: List[str] = []
        for name in families:
            cls, help_text = meta[name]
            if help_text:
                lines.append(f"# HELP {name} " +
                             help_text.replace("\\", "\\\\")
                             .replace("\n", "\\n"))
            lines.append(f"# TYPE {name} {cls.type_name}")
            for metric in families[name]:
                for sample_name, labels, value in metric.samples():
                    lines.append(f"{sample_name}{_format_labels(labels)} "
                                 f"{_format_value(value)}")
        return "\n".join(lines) + ("\n" if lines else "")


# The process-default registry (train hooks / serve share it when
# no explicit registry is passed to Telemetry).
REGISTRY = Registry()


# ---------------------------------------------------------------------------
# Exposition parser (round-trip tests, programmatic scraping)

_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>.*)\})?\s+(?P<value>\S+)\s*$")
_LABEL_PAIR_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def _parse_value(text: str) -> float:
    if text == "+Inf":
        return float("inf")
    if text == "-Inf":
        return float("-inf")
    return float(text)


# The escape alphabet of the exposition format: label values escape
# backslash, double-quote, and newline; HELP text escapes backslash and
# newline.  Decoding must walk the string ONCE — sequential .replace()
# passes corrupt adjacent escapes (a literal backslash followed by a
# literal n renders as ``\\n`` and a ``\\n -> newline`` pass would eat
# the backslash it just decoded).
_ESCAPE_MAP = {"\\": "\\", '"': '"', "n": "\n"}


def _unescape(value: str) -> str:
    if "\\" not in value:
        return value
    out: List[str] = []
    i, n = 0, len(value)
    while i < n:
        c = value[i]
        if c == "\\" and i + 1 < n:
            out.append(_ESCAPE_MAP.get(value[i + 1], "\\" + value[i + 1]))
            i += 2
        else:
            out.append(c)
            i += 1
    return "".join(out)


def parse_exposition(text: str) -> Dict[str, Dict]:
    """Parse exposition text into ``{family: {"type", "help", "samples"}}``
    where samples maps ``(sample_name, labels_tuple) -> value``."""
    out: Dict[str, Dict] = {}

    def family_of(sample_name: str) -> str:
        for suffix in ("_bucket", "_sum", "_count"):
            base = sample_name[: -len(suffix)] if sample_name.endswith(
                suffix) else None
            if base and base in out and out[base]["type"] == "histogram":
                return base
        return sample_name

    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("# HELP "):
            _, _, rest = line.partition("# HELP ")
            name, _, help_text = rest.partition(" ")
            out.setdefault(name, {"type": "untyped", "help": "",
                                  "samples": {}})["help"] = _unescape(
                                      help_text)
            continue
        if line.startswith("# TYPE "):
            _, _, rest = line.partition("# TYPE ")
            name, _, type_name = rest.partition(" ")
            out.setdefault(name, {"type": "untyped", "help": "",
                                  "samples": {}})["type"] = type_name.strip()
            continue
        if line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            raise ValueError(f"unparsable exposition line: {line!r}")
        labels = tuple(
            (k, _unescape(v))
            for k, v in _LABEL_PAIR_RE.findall(m.group("labels") or ""))
        fam = family_of(m.group("name"))
        entry = out.setdefault(fam, {"type": "untyped", "help": "",
                                     "samples": {}})
        entry["samples"][(m.group("name"), labels)] = _parse_value(
            m.group("value"))
    return out


def render_exposition(families: Dict[str, Dict],
                      extra_labels: Optional[Dict[str, str]] = None) -> str:
    """Inverse of :func:`parse_exposition`: render parsed families back
    to exposition text, optionally stamping ``extra_labels`` onto every
    sample (the federation relabel: ``host=``/``replica=``).  An extra
    label whose key a sample already carries overrides it in place, so
    re-federating an already-labelled exposition stays idempotent.
    ``parse_exposition(render_exposition(parse_exposition(t)))`` equals
    ``parse_exposition(t)`` exactly — including histogram ``+Inf``
    buckets and escaped label values, which is what lets the federation
    endpoint proxy peer registries losslessly."""
    extra = tuple((k, str(v)) for k, v in (extra_labels or {}).items())
    for k, _ in extra:
        if not _LABEL_RE.match(k):
            raise ValueError(f"invalid label name {k!r}")
    lines: List[str] = []
    for fam in families:
        entry = families[fam]
        if entry.get("help"):
            lines.append(f"# HELP {fam} " +
                         entry["help"].replace("\\", "\\\\")
                         .replace("\n", "\\n"))
        lines.append(f"# TYPE {fam} {entry.get('type') or 'untyped'}")
        for (sample_name, labels), value in entry["samples"].items():
            if extra:
                keep = tuple((k, v) for k, v in labels
                             if k not in dict(extra))
                labels = keep + extra
            lines.append(f"{sample_name}{_format_labels(labels)} "
                         f"{_format_value(value)}")
    return "\n".join(lines) + ("\n" if lines else "")
