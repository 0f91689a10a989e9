"""``chip_smoke.py`` leaves no process behind: as a child subreaper it gets
the orphans of the children it starts, even one that left their session,
and ``stop_strays`` kills and reaps them before the last lines."""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# A child that starts two grandchildren and ends at once: one in its own
# session (the child's process group is killed without it) and one that
# stays in the group. The smoke's helpers run in a process of their own,
# so that the test process does not become a subreaper.
DRIVER = r"""
import importlib.util, json, os, sys, time
from pathlib import Path
spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[1])
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
cs.become_subreaper()
code = ("import subprocess, sys; "
        "a = subprocess.Popen([sys.executable, '-c', "
        "'import os, time; os.setsid(); time.sleep(120)']); "
        "b = subprocess.Popen(['sleep', '121']); "
        "print('pids', a.pid, b.pid, flush=True)")
out = cs.wait_children({"c": cs.start_child(
    ["-c", code], Path(sys.argv[2]))}, 60)["c"]
pids = [int(p) for p in out[2].split()[1:]]
time.sleep(0.3)
below = sorted(cs.descendants())
stopped = cs.stop_strays()
print(json.dumps({"rc": out[0], "pids": pids, "below": below,
                  "stopped": stopped, "after": sorted(cs.descendants())}))
"""


def test_stop_strays_reaps_orphans_that_left_the_session(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-c", DRIVER, str(ROOT / "chip_smoke.py"),
         str(tmp_path / "child.log")],
        capture_output=True, text=True, timeout=120, cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["rc"] == 0 and len(got["pids"]) == 2
    setsid_pid = got["pids"][0]
    assert setsid_pid in got["below"]           # handed to the subreaper
    assert any("setsid" in cmd for cmd in got["stopped"])
    assert got["after"] == []
    for pid in got["pids"]:                     # gone, not only reparented
        cmdline = Path(f"/proc/{pid}/cmdline")
        assert not cmdline.exists() or b"sleep" not in cmdline.read_bytes()
