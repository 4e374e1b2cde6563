"""maria_torch's public surface against maria_tpu's, name by name.

maria_tpu's modules are read by AST: every public function, class,
method (properties included) and keyword parameter of each module file.
Each must have its counterpart in maria_torch at the mirrored path
(``maria_tpu/a/b.py`` -> ``maria_torch.a.b``), found by importing the
port's module: the name as an attribute, a method or property on the
class, a keyword as a parameter of the signature. What the port does not
carry is listed in ``LEFT_OUT`` with one of the reasons in ``REASONS``;
a second case holds every entry to something that still exists in
maria_tpu, so the list cannot go stale. One case per module.

Keys of ``LEFT_OUT``: "module" (the whole module), "module:name",
"module:Class.method", "module:name(keyword)" or
"module:Class.method(keyword)".
"""

import ast
import importlib
import inspect
import os

import pytest

pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TPU_DIR = os.path.join(ROOT, "maria_tpu")

TPU = "a TPU workaround: the port runs the same work its own way on the card (a hand-written kernel or a gather)"
JAX_RNG = "jax's PRNG key or seed argument: the port draws from a torch.Generator (generator=)"
JAX_DEVICES = "a list of jax devices: a torch rank drives one card (device=)"
CPU_BUILD = "a CPU build for the JAX package (g++/OpenMP), which the port's CUDA kernels replace"
DOWNLOAD = "needs a download (the world height map, maria-data or ERA5), which neither package may fetch offline"
MIXIN = "a sim/*Mixin: the port's Simulation does this work in its own structure (sim/atmosphere.py, cmb.py, map.py)"
REASONS = (TPU, JAX_RNG, JAX_DEVICES, CPU_BUILD, DOWNLOAD, MIXIN)

LEFT_OUT = {
    # TPU workarounds
    "maria_tpu.ops.binning": TPU,
    "maria_tpu.ops.binning_runs": TPU,
    "maria_tpu.ops.fft": TPU,
    "maria_tpu.ops.pallas_binning": TPU,
    "maria_tpu.ops.pallas_noise": TPU,
    "maria_tpu.atmosphere.sampling:sampler_static": TPU,
    "maria_tpu.atmosphere.sampling:sampler_bf16": TPU,
    "maria_tpu.atmosphere.sampling:accumulate_pwv(bs_px)": TPU,
    "maria_tpu.atmosphere.sampling:accumulate_pwv(bs_py)": TPU,
    "maria_tpu.atmosphere.atmosphere:LayerScreen(nx_needed)": TPU,
    "maria_tpu.atmosphere.atmosphere:LayerScreen(ny_needed)": TPU,
    "maria_tpu.atmosphere.atmosphere:ScreenGroup(win_x)": TPU,
    "maria_tpu.atmosphere.atmosphere:ScreenGroup(win_y)": TPU,
    "maria_tpu.atmosphere.atmosphere:ScreenGroup(dec)": TPU,
    "maria_tpu.atmosphere.atmosphere:ScreenGroup(hat_static)": TPU,
    "maria_tpu.noise.streaming:PinkCascade.block_scan": TPU,
    "maria_tpu.noise.streaming:PinkCascade.init_state(shape)": TPU,
    "maria_tpu.ops.interp:phase_major_cells": TPU,
    "maria_tpu.ops.interp:interp_bilinear_windowed": TPU,
    "maria_tpu.ops.interp:fit_chebyshev_2d": TPU,
    "maria_tpu.ops.interp:eval_chebyshev_2d": TPU,
    "maria_tpu.ops.interp:make_table_eval": TPU,
    "maria_tpu.ops.program:BandBlock(power_eval)": TPU,
    "maria_tpu.ops.program:BandBlock(cmb_P0_eval)": TPU,
    "maria_tpu.ops.program:BandBlock(cmb_dPdT_eval)": TPU,
    "maria_tpu.ops.program:BandBlock.det_sel": TPU,
    "maria_tpu.ops.program:TODProgram.permute_detectors": TPU,
    "maria_tpu.ops.program:TODProgram.device_tables": TPU,
    "maria_tpu.parallel:shard_array": TPU,
    "maria_tpu.parallel.binning:ShardedBinPlan": TPU,
    "maria_tpu.parallel.binning:make_sharded_bin_plan": TPU,
    "maria_tpu.parallel.binning:bin_blocked_sharded": TPU,
    # jax's PRNG keys and device lists
    "maria_tpu.atmosphere.atmosphere:Atmosphere.simulate_pwv(key)": JAX_RNG,
    "maria_tpu.atmosphere.fourier:white_rfft2_spectrum(key)": JAX_RNG,
    "maria_tpu.atmosphere.fourier:synthesize_layered_matern_2d(key)": JAX_RNG,
    "maria_tpu.atmosphere.fourier:synthesize_matern_field_2d(key)": JAX_RNG,
    "maria_tpu.atmosphere.process:AutoregressiveProcess.run(key)": JAX_RNG,
    "maria_tpu.atmosphere.sampling:accumulate_pwv(key)": JAX_RNG,
    "maria_tpu.atmosphere.streaming:StreamingExtrusion.initial_state(key)": JAX_RNG,
    "maria_tpu.atmosphere.streaming:StreamingExtrusion.run_chunks(key)": JAX_RNG,
    "maria_tpu.healpix.sht:synalm_cmb_device(seed)": JAX_RNG,
    "maria_tpu.noise:generate_noise_with_knee(key)": JAX_RNG,
    "maria_tpu.noise:generate_2d_fourier_noise(key)": JAX_RNG,
    "maria_tpu.noise.dft:noise_total_matmul(key)": JAX_RNG,
    "maria_tpu.noise.streaming:PinkCascade.init_state(key)": JAX_RNG,
    "maria_tpu.noise.streaming:PinkCascade.block(key)": JAX_RNG,
    "maria_tpu.noise.streaming:StreamingBandNoise.init_state(key)": JAX_RNG,
    "maria_tpu.noise.streaming:StreamingBandNoise.block(key)": JAX_RNG,
    "maria_tpu.ops.program:TODProgram.draw_gains(key)": JAX_RNG,
    "maria_tpu.ops.program:TODProgram.example_args(key)": JAX_RNG,
    "maria_tpu.parallel:create_mesh(devices)": JAX_DEVICES,
    "maria_tpu.parallel.multihost:create_multihost_mesh(devices)": JAX_DEVICES,
    # the JAX package's CPU build
    "maria_tpu.healpix.native": CPU_BUILD,
    # downloads
    "maria_tpu.io.caching:download_from_url": DOWNLOAD,
    "maria_tpu.site:get_height_map": DOWNLOAD,
    "maria_tpu.site:Site.plot": DOWNLOAD,
    # the Simulation's mixins
    "maria_tpu.sim.atmosphere:AtmosphereMixin": MIXIN,
    "maria_tpu.sim.cmb:CMBMixin": MIXIN,
    "maria_tpu.sim.map:MapMixin": MIXIN,
    "maria_tpu.sim.noise": MIXIN,
}

# ROADMAP item 16's names and the keywords listed with them: none may be
# left out unless it needs a download
ITEM_16 = (
    "maria_tpu:debug", "maria_tpu:undebug",
    "maria_tpu.functions:sigmoid", "maria_tpu.functions:inverse_sigmoid", "maria_tpu.functions:matern",
    "maria_tpu.functions:matern_three_halves", "maria_tpu.functions:MaternInterpolator",
    "maria_tpu.utils.linalg:pointing_indices_and_weights",
    "maria_tpu.utils.linalg:compute_pointing_matrix_sparse_indices",
    "maria_tpu.utils.rotations:get_rotation_matrix_2d", "maria_tpu.utils.rotations:get_rotation_matrix_3d",
    "maria_tpu.utils.rotations:get_orthogonal_transform", "maria_tpu.utils.rotations:rotation_matrix_3d",
    "maria_tpu.utils.rotations:compute_aligning_transform",
    "maria_tpu.noise:generate_2d_fourier_noise",
    "maria_tpu.spectrum:AtmosphericSpectrum.emission", "maria_tpu.spectrum:AtmosphericSpectrum.opacity",
    "maria_tpu.spectrum:AtmosphericSpectrum.path_delay", "maria_tpu.spectrum:AtmosphericSpectrum.transmission",
    "maria_tpu.spectrum:AtmosphericSpectrum.nu_min", "maria_tpu.spectrum:AtmosphericSpectrum.nu_max",
    "maria_tpu.spectrum:AtmosphericSpectrum(altitude)", "maria_tpu.spectrum:AtmosphericSpectrum(refresh_cache)",
    "maria_tpu.band:Band.wavelength", "maria_tpu.band:Band.atmosphere_power", "maria_tpu.band:Band.transmission",
    "maria_tpu.band:Band.summary", "maria_tpu.band:Band.plot", "maria_tpu.band:validate_band_config",
    "maria_tpu.band:Band(sensitivity)",
    "maria_tpu.coords.coordinates:Coordinates.project", "maria_tpu.coords.coordinates:Coordinates.hull",
    "maria_tpu.coords.coordinates:Coordinates.boresight", "maria_tpu.coords.coordinates:Coordinates.ndim",
    "maria_tpu.coords.coordinates:Coordinates(dtype)",
    "maria_tpu.errors:PointingError", "maria_tpu.errors:IncompatibleMapError",
    "maria_tpu.errors:ConfigurationError", "maria_tpu.errors:InvalidInstrumentError",
    "maria_tpu.errors:InvalidArrayError", "maria_tpu.errors:InvalidSiteError",
    "maria_tpu.errors:InvalidRegionError", "maria_tpu.errors:FrequencyOutOfBoundsError",
    "maria_tpu.errors:NoSuitablePlansError",
    "maria_tpu.io.parsing:parse_nu", "maria_tpu.io.parsing:parse_stokes", "maria_tpu.io.parsing:parse_t",
    "maria_tpu.io.parsing:parse_v",
    "maria_tpu.io:read_yaml", "maria_tpu.io:humanize", "maria_tpu.io:leftpad", "maria_tpu.io:repr_phi_theta",
    "maria_tpu.io:repr_lat_lon", "maria_tpu.io.logging:progress_bar", "maria_tpu.io.logging:log_duration",
    "maria_tpu.io.logging:profiler",
    "maria_tpu.weather:vapor_pressure", "maria_tpu.weather:dew_point",
    "maria_tpu.weather:dew_point_to_relative_humidity", "maria_tpu.weather:air_density",
    "maria_tpu.weather:Weather.wind_bearing", "maria_tpu.weather:Weather.layers",
    "maria_tpu.site:get_location", "maria_tpu.site:Site(documentation)",
    "maria_tpu.array:Array.from_kwargs", "maria_tpu.array:Array.max_baseline", "maria_tpu.array:Array.plot",
    "maria_tpu.array.generation:generate_square_packing", "maria_tpu.array.generation:generate_triangular_packing",
    "maria_tpu.array.generation:generate_sunflower_packing",
    "maria_tpu.instrument:Instrument.field_of_view", "maria_tpu.instrument:Instrument(documentation)",
    "maria_tpu.plan.plan:Plan.max_vel", "maria_tpu.plan.patterns:generate_scan_offsets",
    "maria_tpu.plan.patterns:daisy_from_phase", "maria_tpu.plan.patterns:smooth_sawtooth",
    "maria_tpu.plan:validate_pointing_kwargs", "maria_tpu.plan:UnsupportedPlanError",
    "maria_tpu.sim.observation:Observation.n_samples", "maria_tpu.sim.observation:Observation.coords",
    "maria_tpu.sim.simulation:Simulation.min_time", "maria_tpu.sim.simulation:Simulation.max_time",
    "maria_tpu.sim.simulation:Simulation.run_obs(obs)",
    "maria_tpu.map.base:Map.z", "maria_tpu.map.base:Map.v", "maria_tpu.map.base:Map.n_nu",
    "maria_tpu.map.base:Map.n_stokes", "maria_tpu.map.base:Map.nu_bin_bounds", "maria_tpu.map.base:Map.shape",
    "maria_tpu.map.healpix:HEALPixMap(z)", "maria_tpu.map.healpix:HEALPixMap(v)",
    "maria_tpu.map.healpix:HEALPixMap(dtype)", "maria_tpu.map.healpix:HEALPixMap(degrees)",
    "maria_tpu.map.healpix:HEALPixMap(resolution)", "maria_tpu.map.healpix:HEALPixMap.pixel_index(theta_lat)",
    "maria_tpu.map.projection:ProjectionMap(dtype)", "maria_tpu.tod.tod:TOD(dtype)", "maria_tpu.tod.tod:TOD(abscal)",
    "maria_tpu.map:load(path)", "maria_tpu.map:load(filename)",
    "maria_tpu.mappers.base:BaseMapper", "maria_tpu.mappers.base:BaseMapper.add_tod",
    "maria_tpu.mappers.base:BaseMapper.postprocess",
    "maria_tpu.utils.signal:decompose(mode)", "maria_tpu.utils:compute_diameter(lazy)",
    "maria_tpu.utils:compute_diameter(MAX_SAMPLE_SIZE)", "maria_tpu.utils:grouper", "maria_tpu.utils:Timer",
    "maria_tpu.utils:humanize_time", "maria_tpu.utils:dms_to_rad", "maria_tpu.utils:hms_to_rad",
    "maria_tpu.atmosphere.process:AutoregressiveProcess(jitter)",
    "maria_tpu.atmosphere.process:AutoregressiveProcess(MIN_SAMPLES_PER_LAYER)",
)


def _kwnames(fn) -> list:
    a = fn.args
    return [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs if x.arg not in ("self", "cls")
            and not x.arg.startswith("_")]


def _is_dataclass(node) -> bool:
    return any("dataclass" in ast.unparse(d) for d in node.decorator_list)


def _module_name(path: str) -> str:
    rel = os.path.relpath(path, ROOT)[: -len(".py")].split(os.sep)
    if rel[-1] == "__init__":
        rel = rel[:-1]
    return ".".join(rel)


def tpu_surface() -> dict:
    """{module: [(key, kind)]}: every public definition of maria_tpu by
    AST, kind "module", "def", "method" or "keyword"."""
    surface = {}
    for dirpath, _, files in sorted(os.walk(TPU_DIR)):
        for f in sorted(files):
            if not f.endswith(".py"):
                continue
            path = os.path.join(dirpath, f)
            module = _module_name(path)
            entries = []
            for node in ast.parse(open(path).read()).body:
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and not node.name.startswith("_"):
                    entries.append((f"{module}:{node.name}", "def"))
                    entries += [(f"{module}:{node.name}({k})", "keyword") for k in _kwnames(node)]
                elif isinstance(node, ast.ClassDef) and not node.name.startswith("_"):
                    entries.append((f"{module}:{node.name}", "def"))
                    init = []
                    if _is_dataclass(node):
                        init = [b.target.id for b in node.body if isinstance(b, ast.AnnAssign)
                                and isinstance(b.target, ast.Name) and not b.target.id.startswith("_")]
                    for b in node.body:
                        if not isinstance(b, (ast.FunctionDef, ast.AsyncFunctionDef)):
                            continue
                        decorators = [ast.unparse(d) for d in b.decorator_list]
                        if b.name == "__init__":
                            init = _kwnames(b)
                        elif not b.name.startswith("_") and not any(d.endswith(".setter") for d in decorators):
                            entries.append((f"{module}:{node.name}.{b.name}", "method"))
                            if not any(d.endswith("property") for d in decorators):
                                entries += [(f"{module}:{node.name}.{b.name}({k})", "keyword")
                                            for k in _kwnames(b)]
                    entries += [(f"{module}:{node.name}({k})", "keyword") for k in init]
            if entries:
                surface[module] = entries
    return surface


SURFACE = tpu_surface()


def _left_out(key: str) -> bool:
    """True if ``key`` or what holds it (its module, its definition, its
    class) is in LEFT_OUT."""
    module, _, rest = key.partition(":")
    name = rest.split("(")[0]
    return any(k in LEFT_OUT for k in (module, key, f"{module}:{name}", f"{module}:{name.split('.')[0]}"))


def _torch_module(module: str):
    return importlib.import_module("maria_torch" + module[len("maria_tpu"):])


def _signature_params(obj) -> dict:
    try:
        return dict(inspect.signature(obj).parameters)
    except (TypeError, ValueError):
        return {}


def missing_in_port(module: str) -> list:
    """The keys of ``module``'s surface that the port lacks and LEFT_OUT
    does not name."""
    port = _torch_module(module)
    missing = []
    for key, kind in SURFACE[module]:
        if _left_out(key):
            continue
        rest = key.partition(":")[2]
        name, _, kw = rest.partition("(")
        kw = kw.rstrip(")")
        owner_name, _, method = name.partition(".")
        obj = getattr(port, owner_name, None)
        if obj is None:
            missing.append(key)
            continue
        if method:
            if inspect.isclass(obj):
                try:
                    static = inspect.getattr_static(obj, method)
                except AttributeError:
                    missing.append(key)
                    continue
                if kind == "keyword":
                    func = static.__func__ if isinstance(static, (classmethod, staticmethod)) else static
                    if isinstance(static, property) or kw not in _signature_params(func):
                        missing.append(key)
            else:
                missing.append(key)
        elif kind == "keyword" and kw not in _signature_params(obj):
            missing.append(key)
    return missing


@pytest.mark.parametrize("module", [m for m in sorted(SURFACE) if m not in LEFT_OUT])
def test_port_has_counterpart(module):
    missing = missing_in_port(module)
    assert not missing, f"maria_torch lacks {missing} (port them or list them in LEFT_OUT with a reason)"


def _tpu_keys() -> set:
    keys = set(SURFACE)
    for entries in SURFACE.values():
        keys.update(k for k, _ in entries)
    return keys


LEFT_OUT_MODULES = sorted({key.partition(":")[0] for key in LEFT_OUT})


@pytest.mark.parametrize("module", LEFT_OUT_MODULES)
def test_left_out_names_exist(module):
    """Every LEFT_OUT entry names something maria_tpu still has, for one
    of the reasons."""
    keys = _tpu_keys()
    entries = {k: v for k, v in LEFT_OUT.items() if k.partition(":")[0] == module}
    stale = [k for k in entries if k not in keys]
    assert not stale, f"LEFT_OUT names what maria_tpu no longer has: {stale}"
    assert all(reason in REASONS for reason in entries.values())


def test_item_16_is_ported():
    """ROADMAP item 16's names and keywords exist in maria_tpu and none is
    left out, except for a download."""
    keys = _tpu_keys()
    assert not [k for k in ITEM_16 if k not in keys]
    left = [k for k in ITEM_16 if _left_out(k) and LEFT_OUT.get(k) != DOWNLOAD]
    assert not left, f"item 16 names left out: {left}"
