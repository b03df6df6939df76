"""Validate a tuned overlap-plan cache and gate it against drift
(DESIGN.md §14), as the reference's ``scripts/check_plan.py``.

Two modes, composable:

* schema: the plan JSON must load as a ``core/policy.TunedPolicy`` —
  supported version, every entry keyed by a known site/method with
  split_frac in (0, 1) and budget in (0, 1] — plus structural checks the
  loader is lenient about (nonzero plan id, no duplicate entry keys,
  bucket labels consistent with the declared edges).
* drift (``--expect``): the plan must be ENTRY-IDENTICAL to a reference
  (the committed ``analysis/plans/h100_default.json``).  Regenerate the
  plan with ``python -m repro_torch.analysis.autotune`` on the default sim
  HW and diff it against the committed cache, so a cost-model or search
  change can never silently invalidate the plan an engine loads.

Exit 0 = pass, 1 = failures (printed one per line).  From ``src/``::

    python -m repro_torch.analysis.check_plan PLAN.json \
        [--expect repro_torch/analysis/plans/h100_default.json]
"""
from __future__ import annotations

import argparse
import json
from typing import List

from repro_torch.core.policy import PLAN_VERSION, TunedPolicy, token_bucket
from repro_torch.core.splitting import MAX_RING_CHANNELS, ring_channels

REGEN_HINT = ("regenerate with: cd src && python -m "
              "repro_torch.analysis.autotune --out "
              "repro_torch/analysis/plans/h100_default.json")


def check_plan(doc: dict) -> List[str]:
    """Schema + structural failures for one plan-cache document."""
    failures: List[str] = []
    try:
        plan = TunedPolicy.from_doc(doc)
    except (ValueError, TypeError, KeyError) as e:
        return [f"plan does not load: {e}"]
    if plan.version != PLAN_VERSION:
        failures.append(f"version {plan.version} != supported "
                        f"{PLAN_VERSION}")
    if plan.plan_id <= 0:
        failures.append(f"plan_id {plan.plan_id} must be positive "
                        f"(0 is reserved for the degenerate threshold "
                        f"policy)")
    if len(plan.bucket_edges) < 2:
        failures.append(f"bucket_edges needs >= 2 edges, got "
                        f"{list(plan.bucket_edges)}")
    if list(plan.bucket_edges) != sorted(set(plan.bucket_edges)):
        failures.append(f"bucket_edges not strictly increasing: "
                        f"{list(plan.bucket_edges)}")
    if not plan.entries:
        failures.append("plan has no entries")
    valid_buckets = {token_bucket(lo, plan.bucket_edges)
                     for lo in plan.bucket_edges}
    seen = set()
    for e in plan.entries:
        key = (e.site, e.bucket, e.tp, e.family)
        if key in seen:
            failures.append(f"duplicate entry key {key}")
        seen.add(key)
        if e.bucket not in valid_buckets:
            failures.append(f"entry {key}: bucket {e.bucket!r} does not "
                            f"match the declared bucket_edges")
        if e.method in ("fused", "fused-unsplit"):
            # fused entries grant K1 its CTA count through the budget; a
            # budget that rounds to zero CTAs (or claims more than the
            # kernel can drive) would over/under-commit the comm resource
            # at runtime — reject it here, not in the engine
            lanes = ring_channels(e.budget)
            if not (1 <= lanes <= MAX_RING_CHANNELS):
                failures.append(
                    f"entry {key}: method {e.method!r} budget {e.budget} "
                    f"maps to {lanes} K1 CTAs (want 1..."
                    f"{MAX_RING_CHANNELS})")
    return failures


def check_drift(doc: dict, expect: dict) -> List[str]:
    """Entry-level diff of a plan against the committed reference."""
    failures: List[str] = []
    for field in ("version", "plan_id", "bucket_edges"):
        if doc.get(field) != expect.get(field):
            failures.append(f"{field}: {doc.get(field)!r} != committed "
                            f"{expect.get(field)!r}")

    def index(d):
        return {(e["site"], e["bucket"], e["tp"], e["family"]): e
                for e in d.get("entries", [])}

    cur, ref = index(doc), index(expect)
    for key in sorted(set(ref) - set(cur)):
        failures.append(f"missing committed entry {key}")
    for key in sorted(set(cur) - set(ref)):
        failures.append(f"extra entry {key} not in committed plan")
    for key in sorted(set(cur) & set(ref)):
        if cur[key] != ref[key]:
            failures.append(f"entry {key} drifted: {cur[key]} != "
                            f"committed {ref[key]}")
    return failures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Validate a tuned overlap-plan cache (DESIGN.md §14)",
        epilog=f"On drift failures: {REGEN_HINT} — then commit the "
               f"regenerated plan alongside the change that moved it.")
    ap.add_argument("plan", help="plan-cache JSON to validate")
    ap.add_argument("--expect", default=None,
                    help="committed reference plan; any entry difference "
                         "fails (the drift gate)")
    args = ap.parse_args(argv)

    with open(args.plan) as f:
        doc = json.load(f)
    failures = check_plan(doc)
    if args.expect:
        with open(args.expect) as f:
            expect = json.load(f)
        failures += check_drift(doc, expect)

    if failures:
        print(f"FAIL: {len(failures)} plan-cache failure(s) in "
              f"{args.plan}:")
        for f_ in failures:
            print(f"  - {f_}")
        if args.expect:
            print(f"hint: {REGEN_HINT}")
        return 1
    n = len(doc.get("entries", []))
    print(f"OK: {args.plan} valid (plan id {doc.get('plan_id')}, "
          f"{n} entries"
          + (", matches committed plan)" if args.expect else ")"))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
