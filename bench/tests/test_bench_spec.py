"""BENCHMARK.json and the files it names: the contract's keys, names and
units, and each cell's pieces where the harness looks for them."""

import ast
import dataclasses
import json
import re
import sys

import pytest
import tiny_copy

ROOT, BENCH = tiny_copy.ROOT, tiny_copy.BENCH
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
LINE = re.compile(r"^[^\t\n\r]{1,200}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def test_the_keys_are_the_contracts():
    assert set(SPEC) == KEYS["top"]
    for part in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in SPEC[part]:
            extra = set(entry) - KEYS[part]
            assert set(entry) >= KEYS[part] and extra <= {"workloads"}, entry
            if part in ("configs", "workloads"):
                assert not extra


def test_names_units_and_lines_use_the_allowed_characters():
    names = []
    for part in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in SPEC[part]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append(entry["name"])
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
            for key in ("why", "layer", "source"):
                if key in entry and part in ("configs", "workloads",
                                             "per_layer"):
                    assert LINE.match(entry[key]), entry[key]
    for w in SPEC["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for c in SPEC["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])
        assert len(c["reduced"]) <= 16
        assert PATH.match(c["file"])
    for part in ("configs", "workloads", "end_to_end", "per_layer"):
        got = [e["name"] for e in SPEC[part]]
        assert len(got) == len(set(got))
    for p in BENCH.rglob("*"):
        if "__pycache__" not in p.parts:
            assert PATH.match(str(p.relative_to(ROOT))), p
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_bounds_cells_and_metrics_keep_the_contracts_rules():
    assert SPEC["paths"] == ["bench"]
    assert SPEC["command"][1] == "bench/run.py"
    assert 1 <= SPEC["run_seconds"] <= 51
    cells = {w["name"] for w in SPEC["workloads"]}
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
        assert set(m.get("workloads", cells)) <= cells
    layers = {}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert set(m["workloads"]) <= cells
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", cells)
        if m["name"].endswith("_roofline") or "mfu" in m["name"].split("."):
            assert m["unit"] == "%"
        layers.setdefault(m["layer"], m["layer"])
    for cell in cells:
        reported = [m for m in SPEC["end_to_end"]
                    if cell in m.get("workloads", cells)]
        assert len(reported) >= 2
        assert any(cell in m["workloads"] for m in SPEC["per_layer"])
    configs = {c["name"] for c in SPEC["configs"]}
    assert configs == {w["config"] for w in SPEC["workloads"]}
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert all(w["chips"] == 1 for w in SPEC["workloads"])


def test_every_piece_a_cell_names_is_where_the_harness_looks():
    for w in SPEC["workloads"]:
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
        assert (BENCH / "limits" / f"{w['name']}.json").is_file()
        traffic = json.loads(
            (BENCH / "traffic" / f"{w['traffic']}.json").read_text())
        assert (BENCH / "modes" / f"{traffic['mode']}.py").is_file()
    for c in SPEC["configs"]:
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["name"] == c["name"] and conf["source"] == c["source"]
        assert conf["reduced"] == c["reduced"]
        assert (BENCH / "reference" / f"{conf['family']}.py").is_file()
        assert (BENCH / "models" / f"{conf['family']}.py").is_file()
    for m in SPEC["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
    for p in (BENCH / "kernels").glob("*.json"):
        assert json.loads(p.read_text())["kernels"]


WIDTH = re.compile(r"(?<!vocab)_size$|_dim$|_rank$|latent|projection|expan"
                   r"|experts_per_tok")


@pytest.mark.parametrize("config", [c["file"] for c in SPEC["configs"]])
def test_reduced_lists_cuts_and_departures_list_the_ports_values(config):
    """``reduced`` names cuts of scale alone, never a width; where the port
    departs from the published model, ``departures`` gives its value as
    run beside the published key, which keeps the published value."""
    conf = json.loads((ROOT / config).read_text())
    assert not any(WIDTH.search(k) for k in conf["reduced"])
    assert set(conf["reduced"]).isdisjoint(conf["departures"])
    for key, d in conf["departures"].items():
        assert d["why"]
        if "as_run" in d:
            assert key in conf and conf[key] != d["as_run"]


@pytest.mark.parametrize("config", [c["file"] for c in SPEC["configs"]])
def test_the_port_is_told_the_configurations_sizes(config):
    sys.path[:0] = [str(BENCH), str(ROOT / "src")]
    import harness

    conf = json.loads((ROOT / config).read_text())
    cfg = harness.port_arch_config(conf)
    assert cfg.n_layers == conf["num_hidden_layers"]
    assert cfg.d_model == conf["hidden_size"]
    assert cfg.n_heads == conf["num_attention_heads"]
    assert cfg.n_kv_heads == conf["num_key_value_heads"]
    assert cfg.vocab_size == conf["vocab_size"]
    assert cfg.rope_theta == conf["rope_theta"]
    assert cfg.tie_embeddings == conf["tie_word_embeddings"]
    moe = dataclasses.asdict(cfg.moe)
    assert moe["n_experts"] == conf["num_experts"]
    assert moe["top_k"] == conf["num_experts_per_tok"]
    assert moe["d_expert"] == conf["intermediate_size"]
    assert moe["capacity_factor"] == conf["capacity_factor"]
    assert moe["aux_loss_weight"] == conf["router_aux_loss_coef"]
    assert moe["n_shared"] == 0 and not moe["first_layer_dense"]


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_the_reference_imports_nothing_of_the_program_or_of_jax():
    for path in (BENCH / "reference").glob("*.py"):
        tops = {name.split(".", 1)[0] for name in _imports(path)}
        assert tops <= {"__future__", "math", "numpy", "torch"}, path


def test_the_harness_imports_no_jax_and_no_jax_package():
    for path in BENCH.rglob("*.py"):
        tops = {name.split(".", 1)[0] for name in _imports(path)}
        assert not tops & {"jax", "jaxlib", "flax", "repro"}, path
