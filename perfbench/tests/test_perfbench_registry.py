"""A configuration, traffic mix or per-layer metric is added by adding files:
the registry finds each by the name BENCHMARK.json gives it."""
import json
import os
import shutil

from perfbench.harness import registry

PKG = registry.PKG


def test_every_name_in_benchmark_json_resolves():
    bench = registry.benchmark()
    for cell in bench["workloads"]:
        cfg = registry.config(bench, cell["config"])
        assert cfg["name"] == cell["config"]
        assert registry.system(cfg["system"]).System
        traffic = registry.traffic(cell["traffic"])
        assert cfg["name"] in traffic["limits"]
    for m in bench["end_to_end"] + bench["per_layer"]:
        mod = registry.metric(m["name"])
        assert mod.UNIT == m["unit"] and mod.SOURCE == m["source"], m["name"]
        if "layer" in m:
            assert mod.LAYER == m["layer"], m["name"]


def test_cells_report_an_end_to_end_and_a_per_layer_metric():
    bench = registry.benchmark()
    for cell in bench["workloads"]:
        e2e = {m["name"] for m in registry.cell_metrics(bench, cell["name"], False)}
        assert "setup_s" in e2e and len(e2e) >= 2
        per = registry.cell_metrics(bench, cell["name"], True)
        assert per and all(m["moves"] in e2e for m in per)


def test_new_files_are_found_without_editing_any(tmp_path):
    root = tmp_path / "checkout"
    pkg = root / "perfbench"
    shutil.copytree(PKG, pkg, ignore=shutil.ignore_patterns("__pycache__"))
    with open(os.path.join(registry.ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    before = {p: p.read_bytes() for p in pkg.rglob("*") if p.is_file()}
    # the new cell's three files
    cfg = json.loads((pkg / "configs" / "twh.json").read_text())
    cfg["name"] = "twh_copy"
    (pkg / "configs" / "twh_copy.json").write_text(json.dumps(cfg))
    tr = json.loads((pkg / "traffic" / "ddpm1000-solo.json").read_text())
    tr["limits"]["twh_copy"] = tr["limits"]["twh"]
    (pkg / "traffic" / "ddpm1000-solo-b2.json").write_text(json.dumps(tr))
    (pkg / "metrics" / "frames_per_clip.py").write_text(
        'LAYER = "end to end"\nUNIT = "frames"\nSOURCE = "host_clock"\n'
        '\ndef read(ctx):\n    return 42.0\n')
    bench["configs"].append({"name": "twh_copy", "source": "x", "file":
                             "perfbench/configs/twh_copy.json", "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "twh-copy", "config": "twh_copy",
                               "traffic": "ddpm1000-solo-b2", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "frames_per_clip.solo", "unit": "frames",
                               "better": "higher", "source": "host_clock", "layer": "end to end",
                               "moves": "frames_per_s", "workloads": ["twh-copy"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    got = registry.benchmark(str(root))
    cell = registry.workload(got, "twh-copy")
    assert registry.config(got, cell["config"], str(root))["name"] == "twh_copy"
    assert "twh_copy" in registry.traffic(cell["traffic"], str(pkg))["limits"]
    assert registry.metric("frames_per_clip.solo", str(pkg)).read(None) == 42.0
    assert [m["name"] for m in registry.cell_metrics(got, "twh-copy", True)] == \
        ["frames_per_clip.solo"]
    for p, data in before.items():
        assert p.read_bytes() == data, f"{p} was edited"
