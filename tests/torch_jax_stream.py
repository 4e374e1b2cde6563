"""maria_tpu's key stream, reproduced with jax.random, as draws for the
port (shared by the tests/test_torch_*.py files).

maria_tpu draws every normal of a realization from one key; the port
takes the same normals as ``draws`` (``TODProgram.fields``,
``total_power_fn()``'s function, ``Simulation.run``), so a stage or a
whole program of each package can be compared on the same numbers.
"""

import jax
import jax.numpy as jnp
import numpy as np


def program_key_draws(ref_program, prog_key, gains: bool = True) -> dict:
    """maria_tpu's normals for its program called with ``prog_key``
    (``_loadings`` and ``draw_gains``): inside it, ops/program.py:297,318
    split atmosphere/noise/gain streams, atmosphere/sampling.py:106 one
    key per screen and group, ops/program.py:327-333 one (buffer_init,
    noise) pair per AR process (atmosphere/process.py:56 draws the
    innovations), ops/program.py:445 + noise/__init__.py:77 the band's
    detector and mode draws, and ops/program.py:487 the gains from the
    third stream."""
    from maria_tpu.atmosphere.fourier import good_fft_size

    key_atm, key_noise, key_gain = jax.random.split(prog_key, 3)
    key_scr, key_ar = jax.random.split(key_atm)
    keys = jax.random.split(key_scr, max(len(ref_program.screens), 1))
    draws = {"screens": [
        None if s.W is None else np.asarray(jax.random.normal(keys[i], (s.ny, s.nx // 2 + 1, 2), dtype=jnp.float32))
        for i, s in enumerate(ref_program.screens)
    ], "noise": [], "modes": []}
    if ref_program.groups:  # fourier.py:57,281: (2J, ny, nx//2+1, 2) normals a group, keys after the screens'
        group_keys = jax.random.split(key_scr, len(ref_program.screens) + len(ref_program.groups))
        draws["groups"] = [
            np.asarray(jax.random.normal(group_keys[len(ref_program.screens) + i],
                                         (2 * g.W.shape[0], g.ny, g.nx // 2 + 1, 2), dtype=jnp.float32))
            for i, g in enumerate(ref_program.groups)
        ]
    processes = list({id(s.process): s.process for s in ref_program.screens if s.process is not None}.values())
    if processes:
        draws["ar"] = []
        for i, p in enumerate(processes):
            key_init, key_scan = jax.random.split(jax.random.fold_in(key_ar, i))
            n_steps = 2 * p.n_extrusion
            draws["ar"].append((
                np.asarray(jax.random.normal(key_init, (p.n_extrusion + n_steps, p.n_cross_section), jnp.float32)),
                np.asarray(jax.random.normal(key_scan, (n_steps, p.A.shape[0]), jnp.float32)),
            ))
    n_f = good_fft_size(len(ref_program.t_fine)) // 2 + 1
    for i, band in enumerate(ref_program.bands):
        _, key_pink, key_modes = jax.random.split(jax.random.fold_in(key_noise, i), 3)
        draws["noise"].append(np.asarray(jax.random.normal(key_pink, (len(band.det_index), n_f, 2), dtype=jnp.float32)))
        k = np.asarray(band.noise_basis).shape[-1] if band.noise_basis is not None and band.corr_prop > 0 else None
        draws["modes"].append(
            None if k is None else np.asarray(jax.random.normal(key_modes, (k, n_f, 2), dtype=jnp.float32))
        )
    if gains:
        draws["gains"] = np.asarray(jax.random.normal(key_gain, (len(ref_program.offsets),)))
    return draws


def jax_draws(ref_program, seed=0) -> dict:
    """maria_tpu's normals for one Simulation.run() with ``seed``: the
    program key is the simulation key's first split
    (sim/simulation.py:126-128,168), drawn from as ``program_key_draws``
    says; the gains come from the next split (sim/simulation.py:207-209)."""
    key = jax.random.key(seed)
    key, prog_key = jax.random.split(key)
    draws = program_key_draws(ref_program, prog_key, gains=False)
    draws.pop("ar", None)
    draws.pop("groups", None)
    _, gain_key = jax.random.split(key)
    draws["gains"] = np.asarray(jax.random.normal(gain_key, (len(ref_program.offsets),)))
    return draws


def to_torch(draws):
    """``draws`` with every array a torch tensor (lists and pairs kept)."""
    import torch

    def conv(x):
        if x is None:
            return None
        if isinstance(x, (list, tuple)):
            return type(x)(conv(v) for v in x)
        return torch.as_tensor(np.array(x))

    return {k: conv(v) for k, v in draws.items()}
