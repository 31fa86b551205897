"""The test harness itself: the root ``conftest.py`` fails a test that runs
past its time limit, and ``pytest.ini`` keeps ``slow`` tests out of the
default run and out of the limit.  Each case runs a small test file in a
pytest subprocess beside copies of the two files, the conftest's limit cut
to 1 s."""
import re
import shutil
import subprocess
import sys
import time
import xml.etree.ElementTree as ET
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

CASES = '''
import time
import pytest

def test_sleeps_past_limit():
    time.sleep(60)

def test_under_limit():
    time.sleep(0.2)

@pytest.mark.slow
def test_slow():
    time.sleep(2)
'''


def run_pytest(tmp_path, *args):
    conftest, n = re.subn(r"^TIME_LIMIT_S = \d+$", "TIME_LIMIT_S = 1",
                          (ROOT / "conftest.py").read_text(), flags=re.M)
    assert n == 1
    (tmp_path / "conftest.py").write_text(conftest)
    shutil.copy(ROOT / "pytest.ini", tmp_path / "pytest.ini")
    (tmp_path / "test_cases.py").write_text(CASES)
    xml = tmp_path / "report.xml"
    t0 = time.monotonic()
    r = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         "-p", "no:xdist", "-p", "no:randomly", f"--junitxml={xml}",
         "test_cases.py", *args],
        cwd=tmp_path, capture_output=True, text=True, timeout=60)
    wall = time.monotonic() - t0
    cases = {c.get("name"): c for c in ET.parse(xml).iter("testcase")}
    return r, wall, cases


def test_time_limit_fails_the_test_and_slow_is_deselected(tmp_path):
    r, wall, cases = run_pytest(tmp_path)
    assert r.returncode == 1, r.stdout[-2000:]
    assert "1 failed, 1 passed, 1 deselected" in r.stdout, r.stdout[-2000:]
    assert ("test_cases.py::test_sleeps_past_limit (call) ran past its "
            "time limit of 1 s") in r.stdout
    assert set(cases) == {"test_sleeps_past_limit", "test_under_limit"}
    assert cases["test_sleeps_past_limit"].find("failure") is not None
    assert cases["test_under_limit"].find("failure") is None
    # The 60 s sleep was cut at its 1 s limit.
    assert float(cases["test_sleeps_past_limit"].get("time")) < 3
    assert wall < 30


def test_slow_runs_on_request_without_the_limit(tmp_path):
    r, _, cases = run_pytest(tmp_path, "-m", "slow")
    assert r.returncode == 0, r.stdout[-2000:]
    assert "1 passed, 2 deselected" in r.stdout, r.stdout[-2000:]
    assert set(cases) == {"test_slow"}
    # It slept past the 1 s limit and still passed.
    assert float(cases["test_slow"].get("time")) >= 2


def test_slow_selects_the_interpret_mode_compiles():
    r = subprocess.run(
        [sys.executable, "-m", "pytest", "--collect-only", "-q",
         "-p", "no:cacheprovider", "-m", "slow", "tests/test_kernels.py"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    ids = {line for line in r.stdout.splitlines() if "::" in line}
    assert ids == {
        "tests/test_kernels.py::test_map_indices_kernel_vs_ref_wide[3-64-8]",
        "tests/test_kernels.py::test_map_indices_kernel_vs_ref_wide[4-64-8]",
        "tests/test_kernels.py::test_map_indices_kernel_vs_ref_wide[8-128-6]",
        "tests/test_kernels.py::test_encode_device_padded_equals_unpadded"
        "[pallas]",
    }
