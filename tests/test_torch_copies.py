"""Anti-drift: the port keeps its own copy of each pure-Python reference
module it needs (it never imports ``repro``). A verbatim copy must equal
the reference source once ``repro.`` is rewritten to ``repro_torch.``; a
copy with deliberate edits may differ only by the lines listed here, each
with its reason."""
from __future__ import annotations

import difflib
import re
from pathlib import Path

import pytest

SRC = Path(__file__).resolve().parents[1] / "src"

VERBATIM = sorted(
    [f"configs/{p.name}" for p in (SRC / "repro" / "configs").glob("*.py")]
    + ["core/interval.py", "core/record.py", "core/slo.py",
       "core/coordinator.py", "core/baselines.py", "core/simulator.py",
       "serving/kv_cache.py", "serving/request.py",
       "serving/scheduler.py", "serving/autotune.py",
       "serving/telemetry.py", "serving/fleet.py", "data/workload.py",
       "ft/watchdog.py"])

# module -> (reason, lines only the reference has, marker of added lines)
EDITED = {
    "core/hardware.py": (
        "adds the datasheet H100 preset and H100_CALIBRATED, whose "
        "compute_eff, mem_eff, host_link_bw and host_link_latency_s are "
        "fitted from wall-clock measurements on the card (the counterpart "
        "of the reference's A10_CALIBRATED), and lists both in PRESETS",
        {'PRESETS = {"a10": A10, "a10_calibrated": A10_CALIBRATED, '
         '"tpu_v5e": TPU_V5E}'},
        re.compile(r"H100|h100|hbm_|peak_flops=|host_link|devices_per_bus"
                   r"|name=|^\)$|^#|PRESETS|^$|Gen5|measured"
                   r"|compute_eff=|mem_eff=")),
    "core/costs.py": (
        "drops the reference's unused jax.numpy, numpy and layers imports",
        {"import jax.numpy as jnp", "import numpy as np",
         "from repro_torch.models import layers as L", ""},
        re.compile(r"^$")),
    "serving/kv_offload.py": (
        "TieredKVAllocator.extend's rollback releases each tail page from "
        "the tier it sits on now: a later swap_out of the same call may have "
        "demoted a page the call just added, and releasing it from the "
        "device pool raised ValueError (ROADMAP Queue C 5)",
        {"            # plane may already have copied them)",
         "                self.device.release_pages(rid, [p])",
         "                assert ref.tier == DEVICE and ref.page == p"},
        re.compile(r"^# |^assert ref\.tier (in \(DEVICE, HOST\)|== HOST or "
                   r"ref\.page == p)$|^self\.pool_of\(ref\.tier\)\."
                   r"release_pages\(rid, \[ref\.page\]\)$")),
}


def _rewritten(rel: str) -> str:
    return re.sub(r"\brepro\.", "repro_torch.",
                  (SRC / "repro" / rel).read_text())


@pytest.mark.parametrize("rel", VERBATIM)
def test_verbatim_copy_matches_reference(rel):
    assert (SRC / "repro_torch" / rel).read_text() == _rewritten(rel), \
        f"src/repro_torch/{rel} drifted from src/repro/{rel}"


@pytest.mark.parametrize("rel", sorted(EDITED))
def test_edited_copy_differs_only_as_listed(rel):
    _reason, removed_ok, added_ok = EDITED[rel]
    ref = _rewritten(rel).splitlines()
    port = (SRC / "repro_torch" / rel).read_text().splitlines()
    removed, added = set(), []
    for line in difflib.unified_diff(ref, port, lineterm="", n=0):
        if line.startswith(("---", "+++", "@@")):
            continue
        if line.startswith("-"):
            removed.add(line[1:])
        elif line.startswith("+"):
            added.append(line[1:].strip())
    assert removed <= removed_ok, removed - removed_ok
    assert all(added_ok.search(a) for a in added), \
        [a for a in added if not added_ok.search(a)]


def _class_source(path: Path, name: str) -> str:
    import ast

    text = path.read_text()
    node = next(n for n in ast.parse(text).body
                if isinstance(n, ast.ClassDef) and n.name == name)
    return ast.get_source_segment(text, node)


def test_elastic_plan_copies_the_reference():
    """``ft/elastic.py`` keeps the reference's ``ElasticPlan`` as it is,
    ``make_mesh`` included, with its import rewritten to the port's
    ``launch.mesh``; ``resume`` is the port's own (a mesh of the ranks
    that exist, on the device the caller names)."""
    ref = _class_source(SRC / "repro" / "ft" / "elastic.py", "ElasticPlan")
    port = _class_source(SRC / "repro_torch" / "ft" / "elastic.py",
                         "ElasticPlan")
    assert port == ref.replace("from repro.", "from repro_torch.")
