"""The file side of the launch-cost trace plane: :func:`plan_report`.

The port of the JAX package's ``observability/trace.py::plan_report``,
behind ``main.py --plan-report``. It reads the launch-cost ledgers
(``ledger.<fingerprint>.json``, schema ``launch_ledger``) that a run
persisted beside its launch plans, and nothing else. The port writes no
ledger yet: the launch-cost ledger, request traces and the rest of this
plane are queue 1 item 10 of ``ROADMAP.md``, so on the port's own plans
directory the report lists no ledger.
"""

import glob
import os
from typing import Any, Dict, List

from delphi_tpu_torch.parallel import store as dstore


def plan_report(root: str) -> Dict[str, Any]:
    """Every persisted ledger under ``root`` (a plans directory, or one
    holding a ``plans`` directory), its buckets ranked by pad-adjusted
    device milliseconds: the measured cost (device seconds when measured,
    else wall) scaled by padded over useful units, i.e. what the bucket
    would cost if every unit it launched were real work."""
    candidates = [root, os.path.join(root, "plans")]
    ledger_root = next(
        (c for c in candidates
         if glob.glob(os.path.join(c, "ledger.*.json"))), root)
    rows: List[Dict[str, Any]] = []
    n_ledgers = 0
    for path in sorted(glob.glob(
            os.path.join(ledger_root, "ledger.*.json"))):
        doc, status = dstore.read_json(
            path, schema="launch_ledger", site="store.plan",
            root=ledger_root)
        if status != "ok" or not isinstance(doc, dict):
            continue
        n_ledgers += 1
        fp = doc.get("fingerprint") or \
            os.path.basename(path)[len("ledger."):-len(".json")]
        for phase, buckets in sorted((doc.get("phases") or {}).items()):
            for key, entry in sorted(buckets.items()):
                useful = entry.get("useful_units") or 0
                padded = entry.get("padded_units") or 0
                device_s = entry.get("device_s") or 0.0
                wall_s = entry.get("wall_s") or 0.0
                cost_ms = (device_s if device_s > 0.0 else wall_s) * 1e3
                pad_factor = (padded / useful) if useful > 0 else 1.0
                rows.append({
                    "fingerprint": fp, "phase": phase, "bucket": key,
                    "launches": entry.get("count", 0),
                    "useful_units": useful, "padded_units": padded,
                    "pad_waste": round(1.0 - (useful / padded), 4)
                    if padded > 0 else 0.0,
                    "device_ms": round(device_s * 1e3, 3),
                    "wall_ms": round(wall_s * 1e3, 3),
                    "pad_adjusted_device_ms":
                        round(cost_ms * pad_factor, 3),
                })
    rows.sort(key=lambda r: (-r["pad_adjusted_device_ms"],
                             r["fingerprint"], r["phase"], r["bucket"]))
    return {"root": ledger_root, "ledgers": n_ledgers, "buckets": rows}
