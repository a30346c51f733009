"""Fixed-capacity SoA photon ledger.

JAX replacement for Parthenon's per-block ``Swarm`` pools (SURVEY §2c "the big
one"): one flat struct-of-arrays ledger with an ``alive`` mask instead of per-block
pools with defrag. Slots are recycled by rank-order free-slot assignment at sourcing
time (a sort/prefix-sum, replacing ``AddEmptyParticles``/``Defrag``); particle death
just clears the mask (replacing ``MarkParticleForRemoval``/``RemoveMarkedParticles``).

Per-particle storage (reference swarm fields at
``/root/reference/src/jaybenne/jaybenne_variables.hpp:49-57`` + framework positions):

  * ``x, y, z``  — position **local to the owning block** (not global, unlike the
    reference): block extents are O(10-100) cells so float32 keeps uniform absolute
    resolution everywhere in the domain, and a block transition is a cheap rebase.
  * ``vx, vy, vz`` — velocity components, |v| = c.
  * ``tau`` — time within the current radiation step in units of dt, in [0, 1]
    (the reference stores absolute time, ``particle.photons.time``; census is
    ``tau >= 1`` instead of ``t >= t_start + dt`` — better float conditioning).
  * ``weight`` — energy weight; ``energy`` — sampled photon energy (frequency proxy).
  * ``block, i, j, k`` — owning block id and cell indices. Cell identity is tracked
    **by integers** through every event (the crossing logic increments them), never
    re-derived from positions in the hot loop: this removes the reference's
    face-nudging epsilons (``transport_utils.hpp:151-159``) and is what makes the
    event loop robust in float32.
  * ``alive`` — active-slot mask.
"""

from __future__ import annotations

import jax.numpy as jnp

from .utils.tree import pytree_dataclass


@pytree_dataclass
class ParticleLedger:
    x: jnp.ndarray
    y: jnp.ndarray
    z: jnp.ndarray
    vx: jnp.ndarray
    vy: jnp.ndarray
    vz: jnp.ndarray
    tau: jnp.ndarray
    weight: jnp.ndarray
    energy: jnp.ndarray
    block: jnp.ndarray
    i: jnp.ndarray
    j: jnp.ndarray
    k: jnp.ndarray
    alive: jnp.ndarray
    # absorbed-this-step flag: absorption events only clear ``alive`` and set this
    # mask; the energy_delta deposition (reference: atomic add at
    # transport.cpp:157-163) becomes ONE segment-sum after the census loop, keeping
    # the hot loop free of scatter ops.
    absorbed: jnp.ndarray
    # face-arrival code: +-(axis+1) when the particle's last event was an IMC cell
    # crossing that pinned it onto a face of its (new) cell — + for the lower face
    # (it was travelling up), - for the upper. 0 otherwise. The IMC->DDMC albedo
    # test (reference ``ptcl_ddmc_albedo``, ``transport_utils.hpp:279-397``) keys on
    # this flag instead of a position-tolerance window: the reference's
    # ``fuzzy_equal`` window (~5.5e-10 relative) only ever catches genuinely pinned
    # IMC arrivals, and a float32-sized window would spuriously catch DDMC census
    # resamples and fresh sources (~1.5%/cycle), adding artificial interface
    # resistance inside optically thick regions.
    face: jnp.ndarray
    # pending DDMC coarse->fine subface resample: +-(axis+1) of a DDMC leak whose
    # destination block is FINER and lives on another shard (spatial
    # decomposition only — the reference's post-communication
    # ``SampleDDMCBlockFace`` pass, ``sample_ddmc_bface.cpp:81-427``). The owning
    # shard resamples on arrival and clears the code; single-shard runs resample
    # inline and never set it.
    leak: jnp.ndarray

    @property
    def capacity(self) -> int:
        return self.x.shape[0]

    def num_alive(self):
        return jnp.sum(self.alive.astype(jnp.int32))

    def global_position(self, mesh):
        """Physical (x, y, z) of each particle (block origin + local offset)."""
        org = mesh.block_origin[self.block]
        return org[:, 0] + self.x, org[:, 1] + self.y, org[:, 2] + self.z


def insert_particles(ledger: ParticleLedger, cand: dict, valid, reserved=None) -> tuple:
    """Scatter candidate particles into the ledger's dead slots.

    ``cand`` maps field name -> candidate array (any shape, flattened); ``valid``
    masks real candidates. Valid candidates are ranked by prefix sum and written to
    dead slots in stable index order (the pool-allocation analog of Parthenon's
    ``AddEmptyParticles``). Returns ``(ledger, n_dropped)`` where dropped candidates
    exceeded the free-slot count.

    ``reserved`` marks rows that are dead but must NOT be recycled yet — the
    spatial census loop inserts migration arrivals mid-step, when absorbed rows
    still carry their weight for the end-of-step absorption tally; overwriting
    one silently destroys that energy.
    """
    import dataclasses as _dc

    cap = ledger.capacity
    vflat = valid.reshape(-1)
    rank = jnp.cumsum(vflat.astype(jnp.int32)) - 1
    occupied = ledger.alive if reserved is None else (ledger.alive | reserved)
    order = jnp.argsort(occupied, stable=True).astype(jnp.int32)  # free first
    n_dead = cap - jnp.sum(occupied.astype(jnp.int32))
    ok = vflat & (rank < n_dead)
    n_dropped = jnp.sum(vflat) - jnp.sum(ok)
    dest = jnp.where(ok, order[jnp.clip(rank, 0, cap - 1)], cap)  # cap -> dropped

    def put(arr, val):
        return arr.at[dest].set(val.reshape(-1).astype(arr.dtype), mode="drop")

    updates = {name: put(getattr(ledger, name), val) for name, val in cand.items()}
    shape = vflat.shape
    updates["alive"] = put(ledger.alive, jnp.ones(shape, dtype=bool))
    if "absorbed" not in cand:
        updates["absorbed"] = put(ledger.absorbed, jnp.zeros(shape, dtype=bool))
    if "face" not in cand:
        updates["face"] = put(ledger.face, jnp.zeros(shape, dtype=jnp.int32))
    if "leak" not in cand:
        updates["leak"] = put(ledger.leak, jnp.zeros(shape, dtype=jnp.int32))
    return _dc.replace(ledger, **updates), n_dropped


def empty_ledger(capacity: int, dtype=jnp.float32) -> ParticleLedger:
    fz = jnp.zeros((capacity,), dtype=dtype)
    iz = jnp.zeros((capacity,), dtype=jnp.int32)
    return ParticleLedger(
        x=fz, y=fz, z=fz,
        vx=fz, vy=fz, vz=fz,
        tau=fz, weight=fz, energy=fz,
        block=iz, i=iz, j=iz, k=iz,
        alive=jnp.zeros((capacity,), dtype=bool),
        absorbed=jnp.zeros((capacity,), dtype=bool),
        face=iz,
        leak=iz,
    )
