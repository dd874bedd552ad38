"""A later change adds a cell, a traffic mix, a configuration and a
per-layer metric as new files and new entries of ``BENCHMARK.json``: in a
copy of the harness, with no file that is there edited, the new cell runs
and its result carries the new metric."""

import json
import shutil
import subprocess
import sys

from conftest import DATA, ROOT


def test_new_files_and_entries_need_no_edit(tmp_path):
    shutil.copytree(ROOT / "bench_port", tmp_path / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: p.read_bytes() for p in (tmp_path / "bench_port").rglob("*") if p.is_file()}
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    new = tmp_path / "bench_port"
    conf = json.loads((DATA / "tiny_fpn.json").read_text())
    (new / "configs" / "small_fpn.json").write_text(json.dumps(dict(conf, name="small_fpn")))
    (new / "traffic" / "serve.small.json").write_text((DATA / "traffic_serve.json").read_text())
    (new / "limits" / "small_fpn.serve.small.json").write_text(
        (DATA / "limits_serve.json").read_text())
    (new / "metrics" / "images.serve.py").write_text(
        '"""Images served in the traced window."""\n\n\n'
        'def read(run):\n    return run["units"] * run["batch"] if run.get("units") else None\n')
    bench["configs"].append({"name": "small_fpn", "source": "a small copy", "reduced": [],
                             "file": "bench_port/configs/small_fpn.json", "why": "test"})
    bench["workloads"].append({"name": "small_fpn.serve.small", "config": "small_fpn",
                               "traffic": "serve.small", "chips": 1, "why": "test"})
    for m in bench["end_to_end"]:
        if "workloads" in m and "fpn_tiny.serve.b16" in m["workloads"]:
            m["workloads"].append("small_fpn.serve.small")
    bench["per_layer"].append({"name": "images.serve", "unit": "img", "better": "higher",
                               "source": "program_counter", "layer": "server",
                               "moves": "serve_img_per_s", "workloads": ["small_fpn.serve.small"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = (
        "import sys, time, json; sys.path[:0] = [%r, %r]\n"
        "import torch; torch.set_num_threads(2)\n"
        "from bench_port import harness\n"
        "assert str(harness.REPO) == %r\n"
        "for trace in (0, 1):\n"
        "    cell = harness.load_cell('small_fpn.serve.small', 9, 0.2, trace, 'cpu',\n"
        "                             time.perf_counter())\n"
        "    print(json.dumps(harness.run_cell(cell)[0]))\n"
    ) % (str(tmp_path), str(ROOT), str(tmp_path))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=tmp_path)
    assert res.returncode == 0, res.stderr[-3000:]
    plain, traced = (json.loads(line) for line in res.stdout.strip().splitlines()[-2:])
    assert plain["correct"] and traced["correct"]
    assert {"serve_img_per_s", "serve_p95_ms", "setup_s"} <= set(plain["metrics"])
    assert traced["metrics"]["images.serve"]["value"] > 0
    after = {p: p.read_bytes() for p in before}
    assert after == before
