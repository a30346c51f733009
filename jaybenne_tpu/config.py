"""Runtime configuration.

The reference's three config tiers (SURVEY §5) collapse to two here:

  1. Runtime parameters: the same ``<block> key = value`` decks, parsed by
     :mod:`jaybenne_tpu.utils.deck` into the typed dataclasses below. Parameter names,
     defaults, and validation mirror ``jaybenne::Initialize``
     (``/root/reference/src/jaybenne/jaybenne.cpp:158-266``) and ``mcblock::Initialize``
     (``src/mcblock/mcblock.cpp:37-150``), including tolerated dead keys.
  2. Host adapter: the reference injects host EOS/opacity types and field names at
     compile time (``src/jaybenne/jaybenne_config.hpp.in``); here the host simply
     passes model objects and the field adapter is the ``rho``/``sie`` inputs and
     ``energy update`` output of the jitted step — no code generation needed.

All geometry/physics choices that affect traced code (mesh shape, model types, flags)
are static Python values so each distinct configuration compiles once.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import jax.numpy as jnp

from .models import eos as eos_models
from .models import opacity as opacity_models
from .utils.deck import Deck, DeckError



# census path values (step.census_path)
USE_PALLAS_MODES = ("auto", "on", "off", "interpret")

class SourceStrategy(enum.Enum):
    uniform = "uniform"
    energy = "energy"  # parsed but rejected at runtime, like sourcing.cpp:38-39


class InitialRadiation(enum.Enum):
    none = "none"
    thermal = "thermal"


class BC(enum.Enum):
    """Particle (swarm) boundary conditions per domain face."""

    periodic = "periodic"
    outflow = "outflow"
    reflecting = "jaybenne_reflecting"


@dataclasses.dataclass(frozen=True)
class RefinementRegion:
    level: int
    x1min: float
    x1max: float
    x2min: float
    x2max: float
    x3min: float
    x3max: float


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """``<parthenon/mesh>`` + ``<parthenon/meshblock>`` +
    ``<parthenon/static_refinement*>`` (see ``inputs/stepdiff_smr_hybrid.in``)."""

    nx1: int
    nx2: int
    nx3: int
    x1min: float
    x1max: float
    x2min: float
    x2max: float
    x3min: float
    x3max: float
    # meshblock size (defaults to whole mesh = single block)
    mbnx1: int = 0
    mbnx2: int = 0
    mbnx3: int = 0
    refinement: str = "none"
    refinement_regions: tuple = ()
    # particle BCs per face, from <parthenon/swarm>
    swarm_bc: tuple = (BC.periodic,) * 6  # (ix1, ox1, ix2, ox2, ix3, ox3)
    # field BCs per face, from <parthenon/mesh> ix1_bc etc. ("periodic"/"outflow"/...)
    field_bc: tuple = ("periodic",) * 6

    @property
    def periodic_flags(self):
        """(x, y, z) periodicity of the field ghost semantics."""
        return (
            self.field_bc[0] == "periodic",
            self.field_bc[2] == "periodic",
            self.field_bc[4] == "periodic",
        )

    @property
    def ndim(self) -> int:
        return 3 if self.nx3 > 1 else (2 if self.nx2 > 1 else 1)

    @property
    def block_shape(self):
        """(nx3, nx2, nx1) cells per block."""
        return (self.mbnx3 or self.nx3, self.mbnx2 or self.nx2, self.mbnx1 or self.nx1)


@dataclasses.dataclass(frozen=True)
class TimeConfig:
    tlim: float
    integrator: str = "rk1"


@dataclasses.dataclass(frozen=True)
class OutputConfig:
    file_type: str = "hdf5"
    dt: float = 0.0
    variables: tuple = ()
    swarms: tuple = ()
    swarm_variables: tuple = ()


@dataclasses.dataclass(frozen=True)
class JaybenneConfig:
    """``<jaybenne>`` parameters (``src/jaybenne/jaybenne.cpp:163-224``)."""

    num_particles: int
    dt: float = float(jnp.finfo(jnp.float64).max)
    min_swarm_occupancy: float = 0.0
    numin: float = float(jnp.finfo(jnp.float64).tiny)
    numax: float = float(jnp.finfo(jnp.float64).max)
    unique_rank_seeds: bool = True
    seed: int = 123
    max_transport_iterations: int = 10000
    use_ddmc: bool = False
    tau_ddmc: float = 5.0
    source_strategy: SourceStrategy = SourceStrategy.uniform
    do_emission: bool = True
    do_feedback: bool = True
    # --- extensions of this build (not in the reference) ----------------------
    # particle-ledger capacity headroom over num_particles (census survivors +
    # one step of emission births must fit; overflow is detected and reported)
    capacity_factor: float = 2.0
    precision: str = "f32"  # "f32" (default) | "f64" (needs jax_enable_x64)
    # devices to distribute over (0 = all visible); replaces mpiexec -n N
    n_devices: int = 1
    # "particle" (sharded ledger, replicated fields — the default) or "spatial"
    # (sharded blocks + all_to_all migration — the reference's decomposition)
    decomposition: str = "particle"
    # census path (step.census_path): "auto" (the Pallas census kernel on a GPU
    # where it applies, else the XLA event loop), "on" (the kernel; raises where
    # it cannot run), "off" (the XLA loop), "interpret" (the kernel in the Pallas
    # interpreter — tests only)
    use_pallas: str = "auto"
    # spatial decomposition: cap on census migration rounds per step (the
    # migration-loop analog of max_transport_iterations; the reference's
    # iterative task list is bounded the same way, jaybenne.cpp:195-197)
    max_migration_rounds: int = 128
    # spatial decomposition: per-destination-shard migration buffer size
    # (particles per all_to_all slot); 0 = auto (capacity / (2 * n_shards)).
    # Overflowing sends are lossless — they ride the next round.
    migration_buffer_k: int = 0
    # spatial decomposition, XLA census path: iteration budget per migration
    # round (0 = run each round to local completion). Without a budget a
    # particle that crosses shards k times waits out k-1 nearly-full local
    # censuses (paused lanes idle while each round drains), so the worst
    # device's iteration total grows ~(k+1)x the single-shard census length.
    # With a budget B the rounds interleave: total ~ census length + hops * B.
    # Ignored by the Pallas spatial kernels (their bucketing rounds already
    # interleave migration candidates). The XLA path's per-round overhead is a
    # few event-loop iterations' worth, so a fairly tight default is safe.
    # Measured A/B (8-dev CPU spatial stepdiff, 16k particles): budget 128 ->
    # 287 s / 21.4k summed iters, budget 1024 -> 1214 s / 93.4k iters at the
    # SAME ~205 migration rounds — round count is set by migration hops, so a
    # loose budget only buys idle-lane iterations on the drained shards.
    census_iters_per_round: int = 128
    # per-cycle host-side invariant validation (PARTHENON_DEBUG_REQUIRE analog)
    debug_checks: bool = False
    # --- external volume radiation source (extension of this build) ---------
    # Isotropic radiation injected at a fixed energy-density rate q
    # [erg/cm^3/s] inside an axis-aligned box while t < tmax — the driving
    # term of the Su & Olson (1996) non-equilibrium benchmark family; the
    # reference sources only from the matter Planck field (sourcing.cpp).
    external_source_q: float = 0.0
    external_source_tmax: float = 1e300
    # (x1min, x1max, x2min, x2max, x3min, x3max); None = the whole domain
    external_source_box: Optional[tuple] = None
    # particle budget per step for the external source (0 = num_particles)
    external_source_num: int = 0
    # Planck spectrum temperature of the injected photons (0 = local matter
    # temperature; only frequency-dependent models can tell the difference)
    external_source_temperature: float = 0.0

    def __post_init__(self):
        if not (0.0 <= self.min_swarm_occupancy < 1.0):
            raise DeckError("min_swarm_occupancy must be >= 0 and < 1")
        if self.source_strategy == SourceStrategy.energy:
            # parity with the runtime rejection at sourcing.cpp:38-39
            raise DeckError("Energy source strategy not implemented!")
        if self.precision not in ("f32", "f64"):
            raise DeckError("precision must be f32 or f64")
        if self.decomposition not in ("particle", "spatial"):
            raise DeckError("decomposition must be particle or spatial")
        if self.use_pallas not in USE_PALLAS_MODES:
            raise DeckError(f"use_pallas must be one of {USE_PALLAS_MODES}")
        if self.census_iters_per_round < 0:
            raise DeckError("census_iters_per_round must be >= 0")
        if self.max_migration_rounds < 1:
            raise DeckError("max_migration_rounds must be >= 1")
        if self.migration_buffer_k < 0:
            raise DeckError("migration_buffer_k must be >= 0")
        if self.external_source_q < 0:
            raise DeckError("external_source must be >= 0")
        if self.external_source_num < 0:
            raise DeckError("external_source_num must be >= 0")

    @property
    def dtype(self):
        return jnp.float64 if self.precision == "f64" else jnp.float32


@dataclasses.dataclass(frozen=True)
class McblockConfig:
    """``<mcblock>`` parameters (``src/mcblock/mcblock.cpp:44-145``)."""

    problem_id: str
    initial_temperature: float
    initial_density: float
    initial_radiation: InitialRadiation
    gamma: float = 1.66666666667
    cv: Optional[float] = None
    time_scale: float = 1.0
    mass_scale: float = 1.0
    length_scale: float = 1.0
    temperature_scale: float = 1.0
    opacity_model: str = "none"
    opacity_constant_value: float = 0.0
    opacity_table_file: str = ""
    scattering_model: str = "none"
    scattering_constant_value: float = 0.0
    apm: float = 1.0
    # "ideal" (gamma-law, the reference's singularity::IdealGas) or
    # "power_law_cv" (cv = cv_alpha * T^cv_exponent — Su-Olson-type material)
    eos_model: str = "ideal"
    cv_alpha: float = 1.0
    cv_exponent: float = 3.0

    def build_eos(self):
        if self.eos_model == "power_law_cv":
            base = eos_models.PowerLawCv(alpha=self.cv_alpha, n=self.cv_exponent)
        elif self.eos_model == "ideal":
            cv = self.cv if self.cv is not None else 1.0 / (self.gamma - 1.0)
            base = eos_models.IdealGas(gm1=self.gamma - 1.0, cv=cv)
        else:
            raise DeckError("Only ideal or power_law_cv eos models supported!")
        return eos_models.UnitSystemEOS(
            base,
            time_scale=self.time_scale,
            mass_scale=self.mass_scale,
            length_scale=self.length_scale,
            temperature_scale=self.temperature_scale,
        )

    def build_opacity(self):
        if self.opacity_model == "none":
            base = opacity_models.Gray(0.0)
        elif self.opacity_model == "constant":
            base = opacity_models.Gray(self.opacity_constant_value)
        elif self.opacity_model == "ep_bremss":
            base = opacity_models.EPBremss()
        elif self.opacity_model == "table":
            base = opacity_models.TabulatedOpacity.from_file(self.opacity_table_file)
        else:
            raise DeckError(
                "Only none, constant, ep_bremss, or table opacity models supported!"
            )
        return opacity_models.NonCGSUnits(
            base,
            time_scale=self.time_scale,
            mass_scale=self.mass_scale,
            length_scale=self.length_scale,
            temperature_scale=self.temperature_scale,
        )

    def build_scattering(self):
        if self.scattering_model == "none":
            base = opacity_models.GrayS(0.0, self.apm)
        elif self.scattering_model == "constant":
            base = opacity_models.GrayS(self.scattering_constant_value, self.apm)
        elif self.scattering_model == "thomson":
            base = opacity_models.ThomsonS(self.apm)
        else:
            raise DeckError("Only none or constant scattering models supported!")
        return opacity_models.NonCGSUnitsS(
            base,
            time_scale=self.time_scale,
            mass_scale=self.mass_scale,
            length_scale=self.length_scale,
            temperature_scale=self.temperature_scale,
        )


@dataclasses.dataclass(frozen=True)
class RunConfig:
    problem_id: str
    mesh: MeshConfig
    time: TimeConfig
    jaybenne: JaybenneConfig
    mcblock: McblockConfig
    outputs: tuple = ()


def _parse_bcs(deck: Deck) -> tuple:
    faces = ["ix1_bc", "ox1_bc", "ix2_bc", "ox2_bc", "ix3_bc", "ox3_bc"]
    out = []
    for f in faces:
        name = deck.get_or_add_str("parthenon/swarm", f, "periodic")
        try:
            out.append(BC(name))
        except ValueError:
            raise DeckError(f"unknown swarm boundary condition {name!r}") from None
    return tuple(out)


def _parse_refinement(deck: Deck) -> tuple:
    regions = []
    for block in deck.blocks:
        if block.startswith("parthenon/static_refinement"):
            regions.append(
                RefinementRegion(
                    level=deck.get_int(block, "level"),
                    x1min=deck.get_real(block, "x1min"),
                    x1max=deck.get_real(block, "x1max"),
                    x2min=deck.get_or_add_real(block, "x2min", -0.5),
                    x2max=deck.get_or_add_real(block, "x2max", 0.5),
                    x3min=deck.get_or_add_real(block, "x3min", -0.5),
                    x3max=deck.get_or_add_real(block, "x3max", 0.5),
                )
            )
    return tuple(regions)


def from_deck(deck: Deck) -> RunConfig:
    """Build the full static run configuration from a parsed deck."""
    problem_id = deck.get_str("parthenon/job", "problem_id")

    mb = "parthenon/meshblock" in deck.blocks
    mesh = MeshConfig(
        nx1=deck.get_int("parthenon/mesh", "nx1"),
        nx2=deck.get_or_add_int("parthenon/mesh", "nx2", 1),
        nx3=deck.get_or_add_int("parthenon/mesh", "nx3", 1),
        x1min=deck.get_real("parthenon/mesh", "x1min"),
        x1max=deck.get_real("parthenon/mesh", "x1max"),
        x2min=deck.get_or_add_real("parthenon/mesh", "x2min", -0.5),
        x2max=deck.get_or_add_real("parthenon/mesh", "x2max", 0.5),
        x3min=deck.get_or_add_real("parthenon/mesh", "x3min", -0.5),
        x3max=deck.get_or_add_real("parthenon/mesh", "x3max", 0.5),
        mbnx1=deck.get_or_add_int("parthenon/meshblock", "nx1", 0) if mb else 0,
        mbnx2=deck.get_or_add_int("parthenon/meshblock", "nx2", 0) if mb else 0,
        mbnx3=deck.get_or_add_int("parthenon/meshblock", "nx3", 0) if mb else 0,
        refinement=deck.get_or_add_str("parthenon/mesh", "refinement", "none"),
        refinement_regions=_parse_refinement(deck),
        swarm_bc=_parse_bcs(deck),
        field_bc=tuple(
            deck.get_or_add_str("parthenon/mesh", f, "periodic")
            for f in ("ix1_bc", "ox1_bc", "ix2_bc", "ox2_bc", "ix3_bc", "ox3_bc")
        ),
    )

    time = TimeConfig(
        tlim=deck.get_real("parthenon/time", "tlim"),
        integrator=deck.get_or_add_str("parthenon/time", "integrator", "rk1"),
    )
    if time.integrator != "rk1":
        # parity with mcblock.cpp:40-41
        raise DeckError("McBlock driver only supports first order time integration")

    jb = JaybenneConfig(
        num_particles=deck.get_int("jaybenne", "num_particles"),
        dt=deck.get_or_add_real("jaybenne", "dt", 1e300),
        min_swarm_occupancy=deck.get_or_add_real("jaybenne", "min_swarm_occupancy", 0.0),
        numin=deck.get_or_add_real("jaybenne", "numin", 1e-300),
        numax=deck.get_or_add_real("jaybenne", "numax", 1e300),
        unique_rank_seeds=deck.get_or_add_bool("jaybenne", "unique_rank_seeds", True),
        seed=deck.get_or_add_int("jaybenne", "seed", 123),
        max_transport_iterations=deck.get_or_add_int(
            "jaybenne", "max_transport_iterations", 10000
        ),
        use_ddmc=deck.get_or_add_bool("jaybenne", "use_ddmc", False),
        tau_ddmc=deck.get_or_add_real("jaybenne", "tau_ddmc", 5.0),
        source_strategy=SourceStrategy(
            deck.get_or_add_str("jaybenne", "source_strategy", "uniform")
        ),
        do_emission=deck.get_or_add_bool("jaybenne", "do_emission", True),
        do_feedback=deck.get_or_add_bool("jaybenne", "do_feedback", True),
        capacity_factor=deck.get_or_add_real("jaybenne", "capacity_factor", 2.0),
        precision=deck.get_or_add_str("jaybenne", "precision", "f32"),
        n_devices=deck.get_or_add_int("jaybenne", "n_devices", 1),
        decomposition=deck.get_or_add_str("jaybenne", "decomposition", "particle"),
        use_pallas=deck.get_or_add_str("jaybenne", "use_pallas", "auto"),
        max_migration_rounds=deck.get_or_add_int(
            "jaybenne", "max_migration_rounds", 128
        ),
        migration_buffer_k=deck.get_or_add_int("jaybenne", "migration_buffer_k", 0),
        census_iters_per_round=deck.get_or_add_int(
            "jaybenne", "census_iters_per_round", 128
        ),
        debug_checks=deck.get_or_add_bool("jaybenne", "debug_checks", False),
        external_source_q=deck.get_or_add_real("jaybenne", "external_source", 0.0),
        external_source_tmax=deck.get_or_add_real(
            "jaybenne", "external_source_tmax", 1e300
        ),
        external_source_box=tuple(
            deck.get_or_add_real("jaybenne", f"external_source_{k}", d)
            for k, d in (
                ("x1min", mesh.x1min), ("x1max", mesh.x1max),
                ("x2min", mesh.x2min), ("x2max", mesh.x2max),
                ("x3min", mesh.x3min), ("x3max", mesh.x3max),
            )
        ),
        external_source_num=deck.get_or_add_int(
            "jaybenne", "external_source_num", 0
        ),
        external_source_temperature=deck.get_or_add_real(
            "jaybenne", "external_source_temperature", 0.0
        ),
    )

    gamma = deck.get_or_add_real("mcblock", "gamma", 1.66666666667)
    mc = McblockConfig(
        problem_id=problem_id,
        initial_temperature=deck.get_real("mcblock", "initial_temperature"),
        initial_density=deck.get_real("mcblock", "initial_density"),
        initial_radiation=InitialRadiation(
            deck.get_str("mcblock", "initial_radiation")
        ),
        gamma=gamma,
        cv=deck.get_or_add_real("mcblock", "cv", 1.0 / (gamma - 1.0)),
        time_scale=deck.get_or_add_real("mcblock", "time_scale", 1.0),
        mass_scale=deck.get_or_add_real("mcblock", "mass_scale", 1.0),
        length_scale=deck.get_or_add_real("mcblock", "length_scale", 1.0),
        temperature_scale=deck.get_or_add_real("mcblock", "temperature_scale", 1.0),
        opacity_model=deck.get_str("mcblock", "opacity_model"),
        opacity_constant_value=(
            deck.get_real("mcblock", "opacity_constant_value")
            if deck.has("mcblock", "opacity_constant_value")
            else 0.0
        ),
        opacity_table_file=deck.get_or_add_str("mcblock", "opacity_table_file", ""),
        scattering_model=deck.get_or_add_str("mcblock", "scattering_model", "none"),
        scattering_constant_value=(
            deck.get_real("mcblock", "scattering_constant_value")
            if deck.has("mcblock", "scattering_constant_value")
            else 0.0
        ),
        apm=deck.get_or_add_real("mcblock", "apm", 1.0),
        eos_model=deck.get_or_add_str("mcblock", "eos_model", "ideal"),
        cv_alpha=deck.get_or_add_real("mcblock", "cv_alpha", 1.0),
        cv_exponent=deck.get_or_add_real("mcblock", "cv_exponent", 3.0),
    )

    outputs = []
    for block in deck.blocks:
        if block.startswith("parthenon/output"):
            outputs.append(
                OutputConfig(
                    file_type=deck.get_or_add_str(block, "file_type", "hdf5"),
                    dt=deck.get_or_add_real(block, "dt", 0.0),
                    variables=tuple(
                        deck.get_list(block, "variables")
                        if deck.has(block, "variables")
                        else ()
                    ),
                    swarms=tuple(
                        deck.get_list(block, "swarms") if deck.has(block, "swarms") else ()
                    ),
                    swarm_variables=tuple(
                        deck.get_list(block, "swarm_variables")
                        if deck.has(block, "swarm_variables")
                        else ()
                    ),
                )
            )

    # spatial + SMR + DDMC is fully supported: local coarse->fine DDMC leaks
    # subface-resample inline; remote ones carry a pending-leak code resolved by
    # the owning shard after migration (parallel/spatial.py), mirroring the
    # reference's post-communication SampleDDMCBlockFace pass run on 8 ranks in
    # its CI (reference .github/workflows/ci.yml:131-135)

    return RunConfig(
        problem_id=problem_id,
        mesh=mesh,
        time=time,
        jaybenne=jb,
        mcblock=mc,
        outputs=tuple(outputs),
    )


def from_file(path) -> RunConfig:
    return from_deck(Deck.from_file(path))
