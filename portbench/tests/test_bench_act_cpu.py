"""The ACT camera's cell (act.bf600-iqubin) rehearsed on the CPU with the
kernels' plain versions: its whole run through the harness, a traced
run's metrics, and the faults and the control that must come out not
correct.

The rehearsal's size: pa4, pa5 and pa6 at 7 beams each (84 detectors in
six bands, so every band still has a focal-plane noise basis), 30 s (600
samples), a CMB at nside 64. The 2-D atmosphere then carries its four
lowest slabs as fine/coarse pairs, which the cell's 0.95 deg arrays over
600 s do not: both kinds of screen are held here. The limits are the
cell's own (``portbench/limits/act.bf600-iqubin.json``): the rehearsal
reads under them with room (atmosphere_gap ~0.006, cmb_gap ~2.6e-4,
noise_gap ~1e-6, the map gaps ~2e-6, ids_gap ~2.4e-4 of the samples).
"""

import json

import pytest
import torch

CELL = "act.bf600-iqubin"
CPU = torch.device("cpu")


def tiny():
    """(config, traffic, limits) of the cell at the rehearsal's size."""
    from portbench import run

    _, _, config, traffic, limits = run.cell_spec(CELL)
    config, traffic = json.loads(json.dumps(config)), dict(traffic)
    for array in config["arrays"].values():
        array["n"] = 7
    config["sky"]["cmb_kwargs"] = {"nside": 64}
    traffic["duration_s"] = 30.0
    return config, traffic, limits


@pytest.fixture(scope="module", autouse=True)
def private_cache(tmp_path_factory):
    import maria_torch

    old = dict(maria_torch.io._cache_state)
    maria_torch.io._cache_state["base"] = str(tmp_path_factory.mktemp("maria-torch-data"))
    yield
    maria_torch.io._cache_state.update(old)


@pytest.fixture(scope="module")
def scene():
    """The entry's state at the rehearsal's size, and one realization."""
    from portbench import run
    from portbench.entries import sim_bin_map as entry

    config, traffic, limits = tiny()
    state = entry.setup(config, traffic, 3, CPU)
    seed = run.realization_seed(3, 0)
    return state, seed, entry.realize(state, seed, run.Spans(False, None)), limits


def not_correct(readings: dict, limits: dict) -> bool:
    return any(v > limits[k] for k, v in readings.items())


def test_rehearsal_is_correct():
    from portbench import run

    config, traffic, limits = tiny()
    r = run.run_cell(CELL, 2**31 + 17, 0.5, False, CPU, config, traffic, limits)
    assert r["checked"] and r["correct"], r["checks"]
    assert set(r["checks"]) == set(limits)
    assert set(r["end_to_end"]) >= {"samples_per_s", "realization_ms_p95", "setup_s"}


def test_rehearsal_traced_reports_the_new_metrics():
    from portbench import run

    config, traffic, limits = tiny()
    r = run.run_cell(CELL, 99, 0.5, True, CPU, config, traffic, limits)
    assert r["correct"], r["checks"]
    layer = r["per_layer"]
    assert {"bin_postprocess_ms", "bin_host_copies", "scene_setup_s"} <= set(layer)
    assert layer["bin_host_copies"]["value"] == 2.0 and layer["bin_postprocess_ms"]["value"] > 0
    # the device's metrics read nothing on the CPU and are left out, never 0
    assert not {"device_idle_pct", "launches_per_realization", "k2_roofline"} & set(layer)


def test_sound_realization_is_correct(scene):
    from portbench.entries import sim_bin_map as entry

    state, seed, out, limits = scene
    readings = entry.readings(out, seed, CPU)
    assert set(readings) == set(limits) and not not_correct(readings, limits), readings


@pytest.mark.parametrize("fault", ["state_unchanged", "half_left_out", "answer_altered", "qu_swapped",
                                   "band_left_out", "control"])
def test_faults_and_control_come_out_not_correct(scene, fault):
    """The harness's faults (the same answer every realization, half of
    the detectors' noise left out, one map value altered where it is
    produced), the two that only a polarized multi-band map can show (Q
    and U swapped, a band left out of the map), and the control (the
    reference one precision step below the configuration's)."""
    from portbench import run
    from portbench.entries import sim_bin_map as entry

    state, seed, out, limits = scene
    if fault == "state_unchanged":
        readings = entry.readings(entry.realize(state, run.realization_seed(3, 1), run.Spans(False, None)), seed, CPU)
    elif fault == "half_left_out":
        fields = {k: v.clone() for k, v in out["tod"].data.items()}
        fields["noise"][fields["noise"].shape[0] // 2:] = 0.0
        readings = entry.readings(out, seed, CPU, fields=fields)
    elif fault == "answer_altered":
        data = torch.as_tensor(out["data"]).clone()
        weight = torch.as_tensor(out["weight"])
        i = int(torch.argmax(weight[0, 0]))
        data[0, 0].view(-1)[i] += 20 * float(data[0, 0].std())
        readings = entry.readings({**out, "data": data}, seed, CPU)
    elif fault == "control":
        readings = entry.control(out, seed, CPU)
    else:
        readings = entry.fault(out, seed, CPU, fault)
    assert not_correct(readings, limits), readings
