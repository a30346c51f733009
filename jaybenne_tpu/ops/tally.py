"""Tallies and fluid feedback — atomic-free segment reductions.

JAX equivalents of:

  * ``EvaluateRadiationEnergy`` (``/root/reference/src/jaybenne/jaybenne.cpp:514-564``):
    zero + per-particle ``Kokkos::atomic_add(weight / dV)`` becomes one
    ``segment_sum`` over live particles' flat cell ids;
  * the absorption deposition (``transport.cpp:157-163``): one ``segment_sum`` over
    the ledger's ``absorbed`` mask, applied after the census loop;
  * ``UpdateFluid`` (``jaybenne.cpp:583-615``): ``u += energy_delta / dV``.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp


def _particle_cell(particles, mesh, block_offset=None, n_local=None):
    """Flat cell index per particle. With ``block_offset`` (sharded-fields spatial
    mode) the index is LOCAL to this shard's [B_local, ...] field slice, and a mask
    of owned live deposits is returned alongside."""
    if block_offset is None:
        return mesh.flat_cell(particles.block, particles.k, particles.j, particles.i), None
    b_local = particles.block - block_offset
    owned = (b_local >= 0) & (b_local < n_local)
    b_local = jnp.clip(b_local, 0, n_local - 1)
    cell = ((b_local * mesh.nz + particles.k) * mesh.ny + particles.j) * mesh.nx + particles.i
    return cell, owned


def evaluate_radiation_energy(fields, particles, mesh, axis_name=None, block_offset=None):
    """Radiation energy density per cell from live particle weights. With a sharded
    particle ledger (``axis_name``), the per-shard partial tallies are ``psum``-ed
    into the replicated field. With ``block_offset`` (sharded fields), each shard
    tallies only its owned particles into its local field slice — no reduction
    (cell ownership is disjoint and particles live with their block)."""
    nc = int(fields.energy_tally.size)
    n_local = fields.energy_tally.shape[0]
    cell, owned = _particle_cell(particles, mesh, block_offset, n_local)
    dv = mesh.block_volume[jnp.clip(particles.block, 0, mesh.n_blocks - 1)]
    mask = particles.alive if owned is None else (particles.alive & owned)
    contrib = jnp.where(mask, particles.weight / dv, 0.0)
    tally = jax.ops.segment_sum(contrib, cell, num_segments=nc)
    if axis_name and block_offset is None:
        tally = jax.lax.psum(tally, axis_name)
    return dataclasses.replace(
        fields, energy_tally=tally.reshape(fields.energy_tally.shape).astype(fields.energy_tally.dtype)
    )


def accumulate_absorption(fields, particles, mesh, axis_name=None, block_offset=None):
    """Add absorbed particle weights into ``energy_delta`` (total energy units)."""
    nc = int(fields.energy_delta.size)
    n_local = fields.energy_delta.shape[0]
    cell, owned = _particle_cell(particles, mesh, block_offset, n_local)
    mask = particles.absorbed if owned is None else (particles.absorbed & owned)
    contrib = jnp.where(mask, particles.weight, 0.0)
    dep = jax.ops.segment_sum(contrib, cell, num_segments=nc)
    if axis_name and block_offset is None:
        dep = jax.lax.psum(dep, axis_name)
    return dataclasses.replace(
        fields,
        energy_delta=fields.energy_delta + dep.reshape(fields.energy_delta.shape).astype(fields.energy_delta.dtype),
    )


def update_fluid(fields, mesh, block_offset=None):
    """Apply net radiation-matter energy exchange to the matter internal energy."""
    B = fields.u.shape[0]
    if block_offset is None:
        dv = mesh.block_volume[:, None, None, None]
    else:
        vol_padded = jnp.concatenate(
            [mesh.block_volume, jnp.ones((B,), mesh.block_volume.dtype)]
        )
        dv = jax.lax.dynamic_slice_in_dim(vol_padded, block_offset, B, 0)[
            :, None, None, None
        ]
    u = fields.u + fields.energy_delta / dv
    return dataclasses.replace(fields, u=u, sie=u / fields.rho)
