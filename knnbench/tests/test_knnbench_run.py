"""run.py fails, printing no result, where it cannot measure: on a
machine with no card, and in a directory without the program."""

import json
import os
import shutil
import subprocess
import sys

from knnbench.spec import HERE, ROOT


def _run(cwd, env_extra=None):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", **(env_extra or {}))
    return subprocess.run(
        [sys.executable, "knnbench/run.py", "--workload", "kitti-scan2map",
         "--seed", str(2**31 + 3), "--seconds", "1", "--trace", "0"],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def _no_result(out: str) -> bool:
    for line in out.splitlines():
        try:
            if "correct" in json.loads(line):
                return False
        except (ValueError, TypeError):
            continue
    return True


def test_run_fails_without_a_card():
    p = _run(ROOT)
    assert p.returncode != 0
    assert _no_result(p.stdout)
    assert "CUDA card" in p.stderr


def test_run_fails_with_only_the_benchmark(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(HERE, tmp_path / "knnbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run(tmp_path, {"PYTHONPATH": ""})
    assert p.returncode != 0
    assert _no_result(p.stdout)
