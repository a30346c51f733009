"""Equations of state.

JAX replacement for the singularity-eos surface jaybenne consumes
(``EOS::TemperatureFromDensityInternalEnergy`` / ``SpecificHeatFromDensityInternalEnergy``;
call sites ``/root/reference/src/jaybenne/jaybenne.cpp:311-312``,
``transport.cpp:124``). Models are small frozen dataclasses of scalars whose methods are
pure jnp functions — trivially vectorized over cell/particle arrays and traceable under
``jit``/``shard_map``; there is no device-copy dance (the reference's ``GetOnDevice``)
because JAX closures capture the scalars directly.

The reference host code builds ``singularity::IdealGas(gamma-1, cv)`` optionally wrapped
in a ``UnitSystem`` (``src/mcblock/mcblock.cpp:78-82``, ``src/mcblock/eos.hpp:21-22``);
both are provided here. The closed-variant dispatch collapses to ordinary Python
polymorphism at trace time (model choice is static per run).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp


@jax.tree_util.register_static
@dataclasses.dataclass(frozen=True)
class IdealGas:
    """Gamma-law gas: ``sie = cv * T``, constant specific heat.

    Matches ``singularity::IdealGas(gm1, cv)`` as constructed at
    ``src/mcblock/mcblock.cpp:78-82``.
    """

    gm1: float  # gamma - 1
    cv: float   # specific heat at constant volume [erg/g/K]

    def temperature_from_density_internal_energy(self, rho, sie):
        del rho  # ideal gas: T independent of density
        return jnp.asarray(sie) / self.cv

    def specific_heat_from_density_internal_energy(self, rho, sie):
        del rho
        return jnp.full(jnp.shape(sie), self.cv, dtype=jnp.result_type(sie))

    def internal_energy_from_density_temperature(self, rho, temp):
        del rho
        return self.cv * jnp.asarray(temp)

    def pressure_from_density_internal_energy(self, rho, sie):
        return self.gm1 * jnp.asarray(rho) * jnp.asarray(sie)


@jax.tree_util.register_static
@dataclasses.dataclass(frozen=True)
class PowerLawCv:
    """Temperature-power-law specific heat: ``cv(T) = alpha * T**n`` per unit
    mass, so ``sie = alpha * T**(n+1) / (n+1)``.

    The ``n = 3`` case linearizes the matter-radiation coupling (``u_m ∝ T^4``
    like the radiation field) — the material of the Su & Olson (1996)
    non-equilibrium radiative-transfer benchmark, which drives a cold such
    medium with an external volume source (``jaybenne/external_source``). The
    reference reaches materials like this through singularity-eos's wider model
    set; its jaybenne call surface (``TemperatureFromDensityInternalEnergy``,
    ``SpecificHeatFromDensityInternalEnergy``, ``jaybenne.cpp:311-312``) is what
    matters and is provided here.
    """

    alpha: float    # cv prefactor [erg/g/K^(n+1)]
    n: float = 3.0  # temperature exponent

    def temperature_from_density_internal_energy(self, rho, sie):
        del rho
        p = self.n + 1.0
        return jnp.maximum(p * jnp.asarray(sie) / self.alpha, 0.0) ** (1.0 / p)

    def specific_heat_from_density_internal_energy(self, rho, sie):
        t = self.temperature_from_density_internal_energy(rho, sie)
        return self.alpha * t**self.n

    def internal_energy_from_density_temperature(self, rho, temp):
        del rho
        p = self.n + 1.0
        return self.alpha * jnp.asarray(temp) ** p / p


@jax.tree_util.register_static
@dataclasses.dataclass(frozen=True)
class UnitSystemEOS:
    """Unit-scale wrapper around an EOS (the reference's
    ``singularity::UnitSystem<IdealGas>`` variant arm, ``src/mcblock/eos.hpp:21``).

    Converts code-unit (rho, sie) to CGS, evaluates the wrapped model, and converts the
    result back to code units.
    """

    base: IdealGas
    time_scale: float = 1.0
    mass_scale: float = 1.0
    length_scale: float = 1.0
    temperature_scale: float = 1.0

    @property
    def _rho_scale(self):
        return self.mass_scale / self.length_scale**3

    @property
    def _sie_scale(self):
        # specific energy: (length/time)^2
        return (self.length_scale / self.time_scale) ** 2

    def temperature_from_density_internal_energy(self, rho, sie):
        t_cgs = self.base.temperature_from_density_internal_energy(
            jnp.asarray(rho) * self._rho_scale, jnp.asarray(sie) * self._sie_scale
        )
        return t_cgs / self.temperature_scale

    def specific_heat_from_density_internal_energy(self, rho, sie):
        cv_cgs = self.base.specific_heat_from_density_internal_energy(
            jnp.asarray(rho) * self._rho_scale, jnp.asarray(sie) * self._sie_scale
        )
        return cv_cgs * self.temperature_scale / self._sie_scale

    def internal_energy_from_density_temperature(self, rho, temp):
        sie_cgs = self.base.internal_energy_from_density_temperature(
            jnp.asarray(rho) * self._rho_scale,
            jnp.asarray(temp) * self.temperature_scale,
        )
        return sie_cgs / self._sie_scale
