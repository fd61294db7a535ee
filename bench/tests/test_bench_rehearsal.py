"""Each cell's whole harness path, rehearsed on the CPU at a tiny size:
the result line has the contract's shape, and no module of JAX or of the
JAX package is loaded."""

import json

import pytest
import tiny_copy

SPEC = json.loads((tiny_copy.ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return tiny_copy.make(tmp_path_factory.mktemp("tiny"))


def _metrics_of(cell, trace):
    if trace:
        e2e = {m["name"] for m in SPEC["end_to_end"]
               if cell in m.get("workloads", [cell])}
        return {m["name"]: m["unit"] for m in SPEC["per_layer"]
                if cell in m.get("workloads", [])
                or ("workloads" not in m and m["moves"] in e2e)}
    return {m["name"]: m["unit"] for m in SPEC["end_to_end"]
            if cell in m.get("workloads", [cell])}


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_a_rehearsal_prints_the_contracts_line(tiny, cell, trace):
    line, forbidden, err = tiny_copy.run(tiny, cell, trace=trace)
    assert forbidden == []
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True, err[-2000:]
    assert line["attempted"] > 0 and line["failed"] == 0
    want = _metrics_of(cell, trace)
    for name, m in line["metrics"].items():
        assert m["unit"] == want[name]
    if not trace:
        assert set(line["metrics"]) == set(want)
        assert line["metrics"]["setup_s"]["value"] > 0
    else:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    for name, c in line["checks"].items():
        assert c["value"] <= c["limit"], name


DENSE = {
    "name": "dense-tiny", "source": "a dense decoder-only LM, llama-style",
    "arch": "granite-34b", "family": "dense_lm",
    "port": {"n_layers": 2, "d_model": 128, "n_heads": 2, "n_kv_heads": 1,
             "d_ff": 64, "vocab_size": 256, "norm": "rmsnorm",
             "activation": "swiglu", "mlp_bias": False,
             "tie_embeddings": False},
    "hidden_size": 128, "intermediate_size": 64, "num_attention_heads": 2,
    "num_key_value_heads": 1, "num_hidden_layers": 2, "vocab_size": 256,
    "rope_theta": 10000.0, "rms_norm_eps": 1e-05, "reduced": [],
    "departures": {"rms_norm_eps": {"as_run": 1e-06,
                                    "why": "the port's RMSNorm adds 1e-6"}},
}


def _add_cell(tiny, base_cell, name, conf):
    """A cell like ``base_cell`` on configuration ``conf``, with a traffic
    mix and limits file of its own, from new files and new entries of
    BENCHMARK.json alone."""
    spec = json.loads((tiny / "BENCHMARK.json").read_text())
    base = next(w for w in spec["workloads"] if w["name"] == base_cell)
    conf_entry = next(c for c in spec["configs"]
                      if c["name"] == base["config"])
    (tiny / f"bench/configs/{conf['name']}.json").write_text(
        json.dumps(conf))
    traffic = json.loads(
        (tiny / "bench/traffic" / f"{base['traffic']}.json").read_text())
    if traffic["mode"] == "train":
        traffic.update(global_batch=4, n_batches=1)
    (tiny / f"bench/traffic/{name}_mix.json").write_text(json.dumps(traffic))
    (tiny / f"bench/limits/{name}.json").write_text(
        (tiny / f"bench/limits/{base_cell}.json").read_text())
    spec["configs"].append(dict(conf_entry, name=conf["name"],
                                file=f"bench/configs/{conf['name']}.json",
                                reduced=conf["reduced"]))
    spec["workloads"].append(dict(base, name=name, config=conf["name"],
                                  traffic=f"{name}_mix"))
    for m in spec["end_to_end"] + spec["per_layer"]:
        if base_cell in m.get("workloads", []):
            m["workloads"].append(name)
    (tiny / "BENCHMARK.json").write_text(json.dumps(spec))


def test_a_cell_is_added_from_files_alone(tmp_path):
    """A throwaway cell: a new configuration, traffic mix and limits file,
    and a BENCHMARK.json entry; no file of the harness edited."""
    tiny = tiny_copy.make(tmp_path)
    spec = json.loads((tiny / "BENCHMARK.json").read_text())
    base = next(w for w in spec["workloads"] if w["name"] == "olmoe.train")
    conf = json.loads((tiny / next(c["file"] for c in spec["configs"]
                                   if c["name"] == base["config"]))
                      .read_text())
    conf.update(name="throwaway", num_hidden_layers=1,
                port=dict(conf["port"], n_layers=1))
    _add_cell(tiny, "olmoe.train", "throwaway.train", conf)
    line, forbidden, _ = tiny_copy.run(tiny, "throwaway.train")
    assert forbidden == [] and line["correct"] is True
    assert set(line["metrics"]) == {"setup_s", "train_tokens_per_s",
                                    "train_step_ms_p90"}


@pytest.mark.parametrize("base_cell", CELLS)
def test_a_second_family_is_added_from_files_alone(tmp_path, base_cell):
    """A cell of a dense LM beside the MoE cells: its reference and its
    family's FLOPs, kernel calls and cache sample are new files
    (``tests/dense_lm/``), its configuration, traffic and limits too; the
    modes and the harness are not edited.  Its traced run reads the
    family's FLOP share."""
    tiny = tiny_copy.make(tmp_path)
    for part in ("models", "reference"):
        (tiny / "bench" / part / "dense_lm.py").write_text(
            (tiny_copy.BENCH / "tests" / "dense_lm" / f"{part}.py")
            .read_text())
    name = "dense." + base_cell.split(".", 1)[1]
    _add_cell(tiny, base_cell, name, DENSE)
    for trace in (False, True):
        line, forbidden, err = tiny_copy.run(tiny, name, trace=trace)
        assert forbidden == [] and line["correct"] is True, err[-2000:]
        want = set(_metrics_of(base_cell, trace))
        if trace:
            assert set(line["metrics"]) <= want
            assert any(n.startswith("mfu.") for n in line["metrics"])
        else:
            assert set(line["metrics"]) == want
