"""Photon absorption opacity and scattering models.

JAX replacement for the singularity-opac surface jaybenne consumes
(``Opacity::AbsorptionCoefficient(rho, T, nu)``, ``Opacity::Emissivity(rho, T)``,
``Scattering::TotalScatteringCoefficient(rho, T, nu)``,
``GetRuntimePhysicalConstants``; call sites ``/root/reference/src/jaybenne/jaybenne.cpp:182,
313``, ``transport.cpp:126-127``). Models are frozen dataclasses of scalars with pure
jnp methods, vectorized over arrays and closed over by jitted kernels.

Model inventory mirrors what mcblock constructs (``src/mcblock/mcblock.cpp:94-145``,
``src/mcblock/opacity.hpp:22-30``):

  * absorption: ``Gray(kappa)`` (also covers ``opacity_model = none`` as
    ``Gray(0)``), ``EPBremss`` — each wrappable in ``NonCGSUnits``;
  * scattering: ``GrayS(kappa_s, apm)`` (covers ``none`` as ``GrayS(0, apm)``),
    ``ThomsonS(apm)`` — each wrappable in ``NonCGSUnitsS``.

Conventions (gray physics, CGS unless wrapped):

  * absorption coefficient  ``alpha = kappa * rho``            [1/cm]
  * total emissivity        ``J = alpha * c * a * T^4``        [erg/cm^3/s]
    (this is the ``J = opacP * c * aR * T^4`` identity stated in the Fleck-factor
    comment at ``src/jaybenne/jaybenne.cpp:281-284``)
  * scattering coefficient  ``sigma_s = (rho / apm) * s``      [1/cm], where ``s`` is a
    per-particle cross section and ``apm`` the average particle mass — matching the
    singularity-opac convention flagged by the TODO at ``src/mcblock/mcblock.cpp:122``.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from ..utils import constants


@dataclasses.dataclass(frozen=True)
class RuntimePhysicalConstants:
    c: float
    sb: float

    @property
    def ar(self) -> float:
        return 4.0 * self.sb / self.c


# ---------------------------------------------------------------- absorption models
@jax.tree_util.register_static
@dataclasses.dataclass(frozen=True)
class Gray:
    """Gray (frequency-independent) absorption opacity ``kappa`` [cm^2/g]."""

    kappa: float
    # frequency-independent: transport may precompute one coefficient per cell
    # instead of evaluating per event (bitwise-identical either way)
    is_gray = True

    def absorption_coefficient(self, rho, temp, nu=None):
        del temp, nu
        return self.kappa * jnp.asarray(rho)

    def emissivity(self, rho, temp):
        alpha = self.kappa * jnp.asarray(rho)
        return alpha * constants.CC * constants.AR * jnp.asarray(temp) ** 4

    def get_runtime_physical_constants(self) -> RuntimePhysicalConstants:
        return RuntimePhysicalConstants(c=constants.CC, sb=constants.SB)


@jax.tree_util.register_static
@dataclasses.dataclass(frozen=True)
class EPBremss:
    """Electron-proton (free-free) bremsstrahlung absorption.

    Capability parity for the reference's ``singularity::photons::EPBremss``
    (constructed at ``src/mcblock/mcblock.cpp:109-113``; no input deck in the snapshot
    exercises it, and the submodule source is absent, so the spectral form follows
    the standard hydrogenic free-free law, Rybicki & Lightman eq. 5.18b with
    Gaunt factor 1):

        alpha_nu = cff * (rho/m_p)^2 * T^{-1/2} * nu^{-3} * (1 - e^{-h nu / k T})

    The frequency argument is the particle's sampled photon energy TAG (the
    reference passes the swarm ``energy`` tag straight through,
    ``transport.cpp:126-127``). Tags are sampled in ``sb * T`` units
    (``ops/planck.py``, reference parity: ``planck.hpp:26-50`` scales by the
    Stefan-Boltzmann runtime constant), so the Planck-consistent mapping is
    ``x = h nu / k T = tag / (sb * T)`` and ``nu = x k T / h``. With ``nu=None``
    (derived-field and sourcing paths) the Kramers Planck mean
    ``kappa_P = kff * rho * T^{-7/2}`` [cm^2/g] is returned instead.
    """

    kff: float = 3.68e22   # Kramers Planck-mean constant [cgs]
    cff: float = 3.692e8   # spectral free-free constant [cgs] (R&L 5.18b)
    is_gray = False

    _MP = 1.67262192369e-24  # proton mass [g]

    def absorption_coefficient(self, rho, temp, nu=None):
        rho = jnp.asarray(rho)
        temp = jnp.asarray(temp)
        if nu is None:
            return self.kff * rho * rho * temp ** (-3.5)
        # tag [sb*T units] -> x = h nu / k T -> nu [Hz]; the low clamp keeps
        # the combined constant / nu^3 factor inside float32 range
        # (cff/m_p^2 ~ 1.3e56 would overflow if assembled naively, hence the
        # cube-root regrouping)
        x = jnp.asarray(nu) / (constants.SB * temp)
        freq = jnp.maximum(x * (constants.KB * temp) / constants.HH, 1.0e10)
        g = (self.cff / self._MP**2) ** (1.0 / 3.0) / freq
        # stimulated-emission factor from the SAME (clamped) frequency as the
        # nu^-3 factor — mixing clamped freq with unclamped x would shrink
        # alpha by ~x/x_clamp in the clamped Rayleigh-Jeans tail
        xc = jnp.clip(freq * constants.HH / (constants.KB * temp), None, 80.0)
        return rho * rho * g * g * g / jnp.sqrt(temp) * (1.0 - jnp.exp(-xc))

    def emissivity(self, rho, temp):
        alpha = self.absorption_coefficient(rho, temp)
        return alpha * constants.CC * constants.AR * jnp.asarray(temp) ** 4

    def get_runtime_physical_constants(self) -> RuntimePhysicalConstants:
        return RuntimePhysicalConstants(c=constants.CC, sb=constants.SB)


@jax.tree_util.register_static
@dataclasses.dataclass(frozen=True)
class NonCGSUnits:
    """Unit-scale wrapper around an absorption model (the reference's
    ``singularity::photons::NonCGSUnits<...>``, ``src/mcblock/mcblock.cpp:100-113``).

    Scales are conversion factors from code units to CGS (all decks use 1.0).
    """

    base: object
    time_scale: float = 1.0
    mass_scale: float = 1.0
    length_scale: float = 1.0
    temperature_scale: float = 1.0

    @property
    def is_gray(self):
        return self.base.is_gray

    @property
    def _rho_scale(self):
        return self.mass_scale / self.length_scale**3

    @property
    def _energy_scale(self):
        return self.mass_scale * self.length_scale**2 / self.time_scale**2

    def absorption_coefficient(self, rho, temp, nu=None):
        alpha_cgs = self.base.absorption_coefficient(
            jnp.asarray(rho) * self._rho_scale,
            jnp.asarray(temp) * self.temperature_scale,
            nu,
        )
        return alpha_cgs * self.length_scale  # [1/cm] -> [1/code-length]

    def emissivity(self, rho, temp):
        emis_cgs = self.base.emissivity(
            jnp.asarray(rho) * self._rho_scale,
            jnp.asarray(temp) * self.temperature_scale,
        )
        # [erg/cm^3/s] -> code energy / code volume / code time
        return emis_cgs * self.length_scale**3 * self.time_scale / self._energy_scale

    def get_runtime_physical_constants(self) -> RuntimePhysicalConstants:
        cgs = self.base.get_runtime_physical_constants()
        return RuntimePhysicalConstants(
            c=cgs.c * self.time_scale / self.length_scale,
            sb=cgs.sb
            * self.time_scale**3
            * self.temperature_scale**4
            / self.mass_scale,
        )


@jax.tree_util.register_static
@dataclasses.dataclass(frozen=True)
class TabulatedOpacity:
    """Tabulated gray Planck-mean opacity kappa(rho, T) with bilinear interpolation in
    log-log space — the analog of singularity-opac's table-based models (the gray
    models above cover everything the reference's decks exercise; tables extend the
    family the way production hosts use singularity, SURVEY §7 "later extensible to
    table interpolants").

    ``log_rho``/``log_T`` are the (ascending, uniform or non-uniform) log10 grid
    axes; ``log_kappa`` is [n_rho, n_T] in log10(cm^2/g). Evaluation clamps to the
    table edges.
    """

    log_rho: tuple
    log_T: tuple
    log_kappa: tuple  # nested tuples so the dataclass stays hashable/static
    is_gray = True

    @classmethod
    def from_arrays(cls, rho, temp, kappa):
        import numpy as np

        return cls(
            log_rho=tuple(np.log10(np.asarray(rho, dtype=float)).tolist()),
            log_T=tuple(np.log10(np.asarray(temp, dtype=float)).tolist()),
            log_kappa=tuple(
                tuple(row) for row in np.log10(np.asarray(kappa, dtype=float))
            ),
        )

    @classmethod
    def from_file(cls, path):
        """Load from an .npz with arrays ``rho`` [nr], ``T`` [nt], ``kappa`` [nr, nt]."""
        import numpy as np

        with np.load(path) as d:
            return cls.from_arrays(d["rho"], d["T"], d["kappa"])

    def _interp(self, rho, temp):
        lr_ax = jnp.asarray(self.log_rho)
        lt_ax = jnp.asarray(self.log_T)
        lk = jnp.asarray(self.log_kappa)
        lr = jnp.clip(jnp.log10(jnp.asarray(rho)), lr_ax[0], lr_ax[-1])
        lt = jnp.clip(jnp.log10(jnp.asarray(temp)), lt_ax[0], lt_ax[-1])
        i = jnp.clip(jnp.searchsorted(lr_ax, lr) - 1, 0, lr_ax.shape[0] - 2)
        j = jnp.clip(jnp.searchsorted(lt_ax, lt) - 1, 0, lt_ax.shape[0] - 2)
        fr = (lr - lr_ax[i]) / (lr_ax[i + 1] - lr_ax[i])
        ft = (lt - lt_ax[j]) / (lt_ax[j + 1] - lt_ax[j])
        v = (
            lk[i, j] * (1 - fr) * (1 - ft)
            + lk[i + 1, j] * fr * (1 - ft)
            + lk[i, j + 1] * (1 - fr) * ft
            + lk[i + 1, j + 1] * fr * ft
        )
        return 10.0**v

    def absorption_coefficient(self, rho, temp, nu=None):
        del nu
        return self._interp(rho, temp) * jnp.asarray(rho)

    def emissivity(self, rho, temp):
        alpha = self.absorption_coefficient(rho, temp)
        return alpha * constants.CC * constants.AR * jnp.asarray(temp) ** 4

    def get_runtime_physical_constants(self) -> RuntimePhysicalConstants:
        return RuntimePhysicalConstants(c=constants.CC, sb=constants.SB)


# ---------------------------------------------------------------- scattering models
@jax.tree_util.register_static
@dataclasses.dataclass(frozen=True)
class GrayS:
    """Gray scattering: per-particle cross section ``s`` [cm^2] with average particle
    mass ``apm`` [g] (``singularity::photons::GrayS(kappa_s, apm)``,
    ``src/mcblock/mcblock.cpp:132-140``)."""

    s: float
    apm: float = 1.0
    is_gray = True

    def total_scattering_coefficient(self, rho, temp, nu=None):
        del temp, nu
        return (jnp.asarray(rho) / self.apm) * self.s


@jax.tree_util.register_static
@dataclasses.dataclass(frozen=True)
class ThomsonS:
    """Thomson scattering (``singularity::photons::ThomsonS`` variant arm,
    ``src/mcblock/opacity.hpp:26-30``)."""

    apm: float = 1.0
    is_gray = True

    def total_scattering_coefficient(self, rho, temp, nu=None):
        del temp, nu
        return (jnp.asarray(rho) / self.apm) * constants.SIGMA_THOMSON


@jax.tree_util.register_static
@dataclasses.dataclass(frozen=True)
class NonCGSUnitsS:
    """Unit-scale wrapper around a scattering model (``NonCGSUnitsS``,
    ``src/mcblock/mcblock.cpp:132-140``)."""

    base: object
    time_scale: float = 1.0
    mass_scale: float = 1.0
    length_scale: float = 1.0
    temperature_scale: float = 1.0

    @property
    def is_gray(self):
        return self.base.is_gray

    @property
    def _rho_scale(self):
        return self.mass_scale / self.length_scale**3

    def total_scattering_coefficient(self, rho, temp, nu=None):
        sig_cgs = self.base.total_scattering_coefficient(
            jnp.asarray(rho) * self._rho_scale,
            jnp.asarray(temp) * self.temperature_scale,
            nu,
        )
        return sig_cgs * self.length_scale
