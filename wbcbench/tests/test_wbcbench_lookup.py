"""A configuration, a traffic mix and a per-layer metric dropped in as new
files, with new entries in BENCHMARK.json, are found by name and run; no
file that was there is edited.  And the manifest agrees with its readers
and keeps to the contract's names."""

import hashlib
import json
import re
import shutil

from _rehearse import rehearse
from wbcbench.harness import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def digest(root):
    return {p.relative_to(root).as_posix(): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_new_files_are_found_by_name(tmp_path):
    home = tmp_path / "wbcbench"
    for sub in ("configs", "traffic", "metrics"):
        shutil.copytree(ROOT / "wbcbench" / sub, home / sub)
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = digest(tmp_path)

    cfg = json.loads((home / "configs" / "tocabi_stand.json").read_text())
    cfg.update(name="tocabi_stand_250nm", torque_limit=250.0)
    (home / "configs" / "tocabi_stand_250nm.json").write_text(json.dumps(cfg))
    mix = json.loads((home / "traffic" / "rollouts_b1024.json").read_text())
    mix.update(batch=3, rollout_ticks=4)
    (home / "traffic" / "rollouts_b3.json").write_text(json.dumps(mix))
    (home / "metrics" / "rollouts_done.batch.py").write_text(
        'LAYER = "serving loop"\nUNIT = "rollouts"\nSOURCE = "program_counter"\n'
        'MOVES = "solves_per_s"\n\n\ndef read(record):\n'
        '    return float(record["counters"]["rollouts"])\n')
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(bench["configs"][0], name="tocabi_stand_250nm",
                                 file="wbcbench/configs/tocabi_stand_250nm.json"))
    bench["workloads"].append({"name": "stand250.batch3", "config": "tocabi_stand_250nm",
                               "traffic": "rollouts_b3", "chips": 1, "why": "a test cell"})
    bench["end_to_end"][0]["workloads"].append("stand250.batch3")
    bench["per_layer"].append({"name": "rollouts_done.batch", "unit": "rollouts",
                               "better": "higher", "source": "program_counter",
                               "layer": "serving loop", "moves": "solves_per_s",
                               "workloads": ["stand250.batch3"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    h, out, line = rehearse("stand250.batch3", trace=True, root=tmp_path,
                            traffic={"batch": 3, "rollout_ticks": 4})
    assert h.config["torque_limit"] == 250.0 and h.traffic["batch"] == 3
    assert line["metrics"]["rollouts_done.batch"]["value"] >= 1
    assert line["correct"] is True
    after = digest(tmp_path)
    assert {k: after[k] for k in before if k != "BENCHMARK.json"} == {
        k: v for k, v in before.items() if k != "BENCHMARK.json"}


def load(name):
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "m", ROOT / "wbcbench" / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_manifest_agrees_with_readers_and_names():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    cells = {c["name"] for c in bench["workloads"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        mod = load(m["name"])
        assert (m["layer"], m["unit"], m["source"], m["moves"]) == (
            mod.LAYER, mod.UNIT, mod.SOURCE, mod.MOVES)
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert set(m["workloads"]) <= cells
        assert all(c in e2e[m["moves"]].get("workloads", cells) for c in m["workloads"])
    for c in bench["workloads"]:
        assert NAME.match(c["name"]) and len(c["why"]) <= 200
        assert (ROOT / "wbcbench" / "traffic" / f"{c['traffic']}.json").exists()
    for c in bench["configs"]:
        assert (ROOT / c["file"]).exists() and c["reduced"] == []
        assert any(w["config"] == c["name"] for w in bench["workloads"])
    fours = sum(c["chips"] == 4 for c in bench["workloads"])
    assert fours <= max(1, len(bench["workloads"]) // 4)
