"""Per-tenant cost metering: who spent the chips, in FLOPs and bytes
(counterpart of heat_tpu/telemetry/tenants.py).

Multi-tenant QoS scheduling (docs/serving.md) makes tenants with
different contracts share one device pool — which makes "which tenant
cost what" a first-class question.  This module is the accountant: the
serving coalescer's ``on_account`` hook settles every coalesced batch
into a per-tenant ledger, attributing the batch's **analyzed** cost
(the dispatch layer's cost-accounting FLOPs/bytes, metered over the
batch's inference by :func:`heat_tpu_torch.core.dispatch.meter_costs`) and
its device time **pro rata by rows** — a tenant that contributed 3 of
a 12-row batch is billed a quarter of the batch, pad rows included, so
the tenant accounts always sum to the work actually dispatched.

The serving layer that feeds it is ROADMAP item 17b; until then the
ledger stays empty unless a caller settles batches itself.

Published as ``/tenantz`` (HTML + ``?format=json``) by the telemetry
server, rolled up across replicas by the fleet router's poller
(``/fleetz`` machinery, :func:`heat_tpu_torch.telemetry.aggregate.
merge_tenant_accounts`), and included in the metrics dump bundle.

Totals are *derived* — :func:`tenantz_report` sums the tenant rows —
so "accounts sum to the total" holds by construction; the interesting
invariant (asserted by the QoS tests) is that the total matches the
fleet-wide work the observatory saw.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

from ..analysis import tsan as _tsan
from . import metrics as _metrics

__all__ = [
    "note_batch",
    "render_tenantz_html",
    "reset",
    "tenantz_report",
]

#: tenant -> account; every field is a lifetime sum except ``class``
#: (last seen) and ``models`` (distinct models served)
_ACCOUNTS: Dict[str, dict] = {}
_STARTED_AT = time.time()
_LOCK = _tsan.register_lock("telemetry.tenants")

_ROWS_C = _metrics.counter("tenants.rows", "rows served across all tenants")
_BATCHES_C = _metrics.counter("tenants.batches", "coalesced batches settled")


def note_batch(
    model: str,
    parts: Sequence[Tuple[str, str, int]],
    flops: float = 0.0,
    bytes_accessed: float = 0.0,
    device_ms: float = 0.0,
) -> None:
    """Settle one coalesced batch into the tenant ledger.

    ``parts`` is ``[(tenant, cls, rows), ...]`` — the batch's true
    membership from the coalescer; ``flops``/``bytes_accessed`` are the
    batch's metered analyzed cost and ``device_ms`` its inference wall
    time.  Split pro rata by rows (the pad overhead lands on the riders
    proportionally), so summing tenant accounts reproduces the batch
    totals exactly up to float addition."""
    total_rows = sum(max(int(n), 0) for _, _, n in parts)
    if total_rows <= 0:
        return
    with _LOCK:
        _tsan.note_access("telemetry.tenants.accounts")
        for tenant, cls, n in parts:
            n = max(int(n), 0)
            if n == 0:
                continue
            share = n / total_rows
            acct = _ACCOUNTS.get(tenant)
            if acct is None:
                acct = _ACCOUNTS[tenant] = {
                    "class": cls,
                    "requests": 0,
                    "rows": 0,
                    "flops": 0.0,
                    "bytes_accessed": 0.0,
                    "device_ms": 0.0,
                    "batches": 0,
                    "models": set(),
                }
            acct["class"] = cls
            acct["requests"] += 1
            acct["rows"] += n
            acct["flops"] += flops * share
            acct["bytes_accessed"] += bytes_accessed * share
            acct["device_ms"] += device_ms * share
            acct["batches"] += 1
            acct["models"].add(model)
    _ROWS_C.inc(total_rows)
    _BATCHES_C.inc()


def reset() -> None:
    """Forget every account (test hook)."""
    with _LOCK:
        _tsan.note_access("telemetry.tenants.accounts")
        _ACCOUNTS.clear()


def tenantz_report(limit: Optional[int] = None) -> dict:
    """The /tenantz document: per-tenant accounts plus derived totals.

    ``{"timestamp", "uptime_s", "tenants": [...], "total": {...}}`` —
    tenants sorted by FLOPs descending (the cost question is "who is
    expensive", not alphabet), capped at ``limit`` with the remainder
    still counted in ``total`` (no silent truncation of the sum)."""
    with _LOCK:
        _tsan.note_access("telemetry.tenants.accounts", write=False)
        rows: List[dict] = [
            {
                "tenant": tenant,
                "class": a["class"],
                "requests": a["requests"],
                "rows": a["rows"],
                "flops": a["flops"],
                "bytes_accessed": a["bytes_accessed"],
                "device_ms": round(a["device_ms"], 3),
                "batches": a["batches"],
                "models": sorted(a["models"]),
            }
            for tenant, a in _ACCOUNTS.items()
        ]
    rows.sort(key=lambda r: (-r["flops"], r["tenant"]))
    total = {
        "tenants": len(rows),
        "requests": sum(r["requests"] for r in rows),
        "rows": sum(r["rows"] for r in rows),
        "flops": sum(r["flops"] for r in rows),
        "bytes_accessed": sum(r["bytes_accessed"] for r in rows),
        "device_ms": round(sum(r["device_ms"] for r in rows), 3),
    }
    if limit is not None:
        rows = rows[: max(int(limit), 0)]
    return {
        "timestamp": time.time(),
        "uptime_s": round(time.time() - _STARTED_AT, 1),
        "tenants": rows,
        "total": total,
    }


def _fmt_count(v: float) -> str:
    for unit in ("", "K", "M", "G", "T", "P"):
        if abs(v) < 1000.0:
            return f"{v:.1f}{unit}" if unit else f"{v:.0f}"
        v /= 1000.0
    return f"{v:.1f}E"


def render_tenantz_html() -> str:
    """Human-readable /tenantz (same data as the JSON form)."""
    rep = tenantz_report()
    rows = "".join(
        "<tr><td>{tenant}</td><td>{cls}</td><td align=right>{reqs}</td>"
        "<td align=right>{rows}</td><td align=right>{flops}</td>"
        "<td align=right>{byts}</td><td align=right>{dms:.1f}</td>"
        "<td>{models}</td></tr>".format(
            tenant=r["tenant"],
            cls=r["class"],
            reqs=r["requests"],
            rows=r["rows"],
            flops=_fmt_count(r["flops"]),
            byts=_fmt_count(r["bytes_accessed"]),
            dms=r["device_ms"],
            models=", ".join(r["models"]),
        )
        for r in rep["tenants"]
    )
    t = rep["total"]
    return (
        "<html><head><title>tenantz</title></head><body>"
        "<h1>Per-tenant cost accounts</h1>"
        f"<p>{t['tenants']} tenants · {t['rows']} rows · "
        f"{_fmt_count(t['flops'])} FLOPs · "
        f"{_fmt_count(t['bytes_accessed'])} bytes · "
        f"{t['device_ms']:.1f} device-ms · uptime {rep['uptime_s']}s</p>"
        "<table border=1 cellpadding=4><tr><th>tenant</th><th>class</th>"
        "<th>requests</th><th>rows</th><th>FLOPs</th><th>bytes</th>"
        "<th>device-ms</th><th>models</th></tr>"
        f"{rows}</table>"
        "<p><a href='/tenantz?format=json'>json</a> · "
        "accounts sum to the totals by construction (pro-rata split)</p>"
        "</body></html>"
    )


_metrics.register_dump_section("tenants", lambda: tenantz_report(limit=64))
