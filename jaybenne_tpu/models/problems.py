"""Problem generators — initial matter state per problem id.

JAX equivalent of ``mcblock::ProblemGenerator`` + ``PostInitialization``
(``/root/reference/src/mcblock/mcblock.cpp:155-262``): every problem initializes
``rho = rho0`` and ``sie = cv * T0`` everywhere; ``stepdiff`` additionally drops the
right half-space (``x >= 0``) to ``T = 1e-5 * T0``; then ``u = rho * sie``.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp

from ..config import RunConfig


def generate_problem(fields, mesh, cfg: RunConfig, dtype):
    mc = cfg.mcblock
    eos = mc.build_eos()
    rho0 = mc.initial_density
    tt0 = mc.initial_temperature

    rho = jnp.full_like(fields.rho, rho0)
    sie0 = eos.internal_energy_from_density_temperature(rho0, tt0)
    sie = jnp.full_like(fields.sie, sie0)

    if cfg.problem_id == "stepdiff":
        xc, _, _ = mesh.cell_centers()
        sie_low = eos.internal_energy_from_density_temperature(rho0, 1.0e-5 * tt0)
        sie = jnp.where(xc >= 0.0, jnp.asarray(sie_low, dtype), sie)

    u = rho * sie  # PostInitialization (mcblock.cpp:237-262)
    return dataclasses.replace(fields, rho=rho, sie=sie, u=u)
