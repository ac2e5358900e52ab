"""Device-mesh scale-out for multi-start phasing.

Replacement for the reference's fork-per-restart multiprocessing
(reference reconstruct.py:141-157 + Multiprocessing.py:799-887, SURVEY.md
§2.8): restarts become a vmapped batch axis sharded over a `jax.sharding.Mesh`
('restarts' = data parallel), and optionally the θ axis of the angular grid is
sharded over a second mesh axis ('theta' — the tensor-parallel analog for this
workload: the SHT Legendre contraction over θ then runs as a sharded matmul
with an XLA-inserted all-reduce). No queues, no shared memory, no RPC — one
jitted SPMD program. Every device reaches every other at the same rate (GPUs
joined all to all by NVLink), so the mesh follows the algorithm alone.
"""
from __future__ import annotations

import os

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(axis_sizes: dict | None = None, devices=None) -> Mesh:
    """Create a Mesh from {'axis_name': size}. Default: all devices on 'restarts'."""
    if devices is None:
        devices = jax.devices()
    if axis_sizes is None:
        axis_sizes = {"restarts": len(devices)}
    names = tuple(axis_sizes)
    shape = tuple(int(v) for v in axis_sizes.values())
    n = int(np.prod(shape))
    if n > len(devices):
        raise ValueError(f"mesh {axis_sizes} needs {n} devices, have {len(devices)}")
    return Mesh(np.asarray(devices[:n]).reshape(shape), names)


def default_mesh_axes(n_devices: int) -> dict:
    """dp×tp factorization: θ-shard over 2 devices when the count allows,
    restarts over the rest."""
    if n_devices % 2 == 0 and n_devices > 2:
        return {"restarts": n_devices // 2, "theta": 2}
    return {"restarts": n_devices}


def _pad_restarts(batch, n_shards: int):
    """Pad the leading (restart) axis to a multiple of n_shards with
    wrap-around copies (also covers n_restarts < n_shards)."""
    n = int(batch.shape[0])
    if n % n_shards == 0:
        return batch
    target = -(-n // n_shards) * n_shards
    idx = np.arange(target) % n
    return batch[idx]


def _batch_sharding(mtip, mesh, restart_axis, theta_axis):
    """Restart-sharded (and, for 3D grids, optionally θ-sharded) layout of
    the density batch → (sharding, number of restart shards)."""
    grid_rank = np.ndim(mtip.initial_support)  # 3 for (r,θ,φ), 2 for (r,φ)
    theta = theta_axis if (theta_axis in mesh.axis_names
                           and grid_rank == 3) else None
    spec = P(restart_axis, None, theta, None) if grid_rank == 3 \
        else P(restart_axis, None, None)
    return NamedSharding(mesh, spec), int(mesh.shape[restart_axis])


def _device_tables(mtip, tables, mesh):
    """→ device-resident tables dict. The big numeric tables (Hankel
    weights, projection matrices — mtip.arg_tables) always enter jit as
    ARGUMENTS: embedded V/PD constants change with every extract output, so
    each dataset would recompile the whole phasing program, and the
    production-scale tables would bloat it by hundreds of MB. A dict is taken
    as already resolved (possibly device-resident): callers that device_put
    their own copy pass it here so the set is not resident twice."""
    if tables is not None:
        return tables
    if not hasattr(mtip, "arg_tables"):
        return {}
    t = mtip.arg_tables()
    if mesh is not None:
        repl = NamedSharding(mesh, P())
        return {k: jax.device_put(v, repl) for k, v in t.items()}
    return jax.device_put(t)


class MultiStartRunner:
    """Jitted multi-start phasing over a device mesh.

    rho0_batch (n_restarts, n_q, n_theta, n_phi) is sharded
    P('restarts', None, 'theta', None); the argument tables (Hankel weights,
    projection data) and the embedded constants (Legendre tables) are
    replicated. Output PhasingStates keep the restart sharding. A restart
    count that the restart axis does not divide is wrap-padded and the
    outputs trimmed back.
    """

    def __init__(self, mtip, schedule, mesh: Mesh | None = None,
                 restart_axis: str = "restarts", theta_axis: str | None = "theta",
                 arg_tables: dict | None = None):
        self.mtip = mtip
        self.schedule = schedule
        self.mesh = mesh
        self._tables = _device_tables(mtip, arg_tables, mesh)
        fn = lambda rho, t: mtip.run_batch(rho, schedule, tables=t)  # noqa: E731
        if mesh is not None:
            self.in_sharding, self._n_shards = _batch_sharding(
                mtip, mesh, restart_axis, theta_axis)
            repl = NamedSharding(mesh, P())
            self._jitted = jax.jit(
                fn, in_shardings=(self.in_sharding,
                                  jax.tree.map(lambda _: repl, self._tables)))
        else:
            self.in_sharding, self._n_shards = None, 1
            self._jitted = jax.jit(fn)

    def __call__(self, rho0_batch):
        n = int(rho0_batch.shape[0])
        rho0_batch = _pad_restarts(rho0_batch, self._n_shards)
        if self.in_sharding is not None:
            rho0_batch = jax.device_put(rho0_batch, self.in_sharding)
        out = self._jitted(rho0_batch, self._tables)
        if int(rho0_batch.shape[0]) != n:
            out = jax.tree.map(lambda x: x[:n], out)
        return out


def rank_restarts(states, errors=None):
    """Host-side: restart indices sorted by best error (ascending), as the
    reference's error-sorted result collection (reconstruct.py:160-184)."""
    best = np.asarray(states.best_err)
    return np.argsort(best), best


def split_schedule_chunks(schedule):
    """Split a flattened schedule at shrink-wrap boundaries: each chunk is a
    run of iteration segments ending with (and including) the next SW. Chunks
    with identical structure share one jit compilation."""
    chunks, current = [], []
    for seg in schedule:
        current.append(seg)
        if seg.method in ("SW", "SW_center"):
            chunks.append(current)
            current = []
    if current:
        chunks.append(current)
    return chunks


def _chunk_structure_args(chunk):
    structure, args = [], []
    for seg in chunk:
        if seg.method in ("SW", "SW_center"):
            structure.append((seg.method,))
            args.append((np.float32(seg.sigma), np.float32(seg.threshold)))
        elif seg.method in ("SNAPSHOT", "RESET_TO_BEST"):
            structure.append((seg.method,))
            args.append(())
        else:
            link = int(getattr(seg, "ft_stab_link_delay", 0) or 0)
            structure.append((seg.method, int(seg.n), bool(seg.ft_stab))
                             if not link else
                             (seg.method, int(seg.n), bool(seg.ft_stab),
                              link))
            args.append(np.asarray(seg.betas, dtype=np.float32))
    return tuple(structure), tuple(args)


def _iteration_table(schedule):
    """Per-iteration (method, β, ft_stab, link delay) over the flattened
    schedule, in global iteration order (SW and marker segments carry no
    iteration)."""
    steps = []
    for seg in schedule:
        if seg.method in ("SW", "SW_center", "SNAPSHOT", "RESET_TO_BEST"):
            continue
        link = int(getattr(seg, "ft_stab_link_delay", 0) or 0)
        for beta in np.asarray(seg.betas, dtype=np.float64):
            steps.append((seg.method, float(beta), bool(seg.ft_stab), link))
    return steps


class CheckpointingRunner:
    """Multi-start runner that executes the schedule in shrink-wrap-bounded
    chunks, snapshotting the full batched PhasingState to disk between chunks
    — mid-run durability the reference lacks (SURVEY.md §5 "no checkpoint
    restart"). Identical chunk structures reuse one compilation because ramp
    values enter as traced arguments (MTIP.run_chunk)."""

    def __init__(self, mtip, schedule, mesh: Mesh | None = None,
                 checkpoint_path: str | None = None, save_every: int = 1,
                 restart_axis: str = "restarts", theta_axis: str = "theta",
                 arg_tables: dict | None = None):
        self.mtip = mtip
        self.schedule = list(schedule)
        self.chunks = split_schedule_chunks(schedule)
        # dynamic ft_stab: the enforce-history length must come from the FULL
        # schedule, not per-chunk sub-schedules (history carries across SWs)
        if hasattr(mtip, "register_schedule_dynamics"):
            mtip.register_schedule_dynamics(schedule)
        self.mesh = mesh
        self.checkpoint_path = checkpoint_path
        self.save_every = max(int(save_every), 1)
        self._compiled = {}
        self._tables = _device_tables(mtip, arg_tables, mesh)
        if mesh is not None:
            self.in_sharding, self._n_shards = _batch_sharding(
                mtip, mesh, restart_axis, theta_axis)
        else:
            self.in_sharding, self._n_shards = None, 1
        # One jit wrapper for the initial state, with the support passed as a
        # device argument: a fresh jax.jit(initial_state_batch) per __call__
        # re-traces and re-hashes the ~50 MB embedded support constant each
        # time at production scale.
        self._init_support = jnp.asarray(np.asarray(mtip.initial_support),
                                         dtype=bool)
        if mesh is not None:  # replicate: inputs must share device sets
            self._init_support = jax.device_put(
                self._init_support, NamedSharding(mesh, P()))
        self._init_state = jax.jit(mtip.initial_state_batch)

    def _step(self, structure):
        if structure not in self._compiled:
            def fn(state, args, tables):
                with self.mtip.bound_tables(tables):
                    return jax.vmap(
                        lambda s: self.mtip.run_chunk(s, structure, args))(
                            state)
            self._compiled[structure] = jax.jit(fn)
        return self._compiled[structure]

    # --------------------------------------------------------- checkpoint IO
    def _save(self, state, errors_list, chunk_index):
        from xframe_tpu.io import hdf5 as hdf5_io
        h = jax.device_get(state)
        data = {
            "chunk_index": int(chunk_index),
            "rho_re": np.real(h.rho), "rho_im": np.imag(h.rho),
            "support": np.asarray(h.support),
            "best_rho_re": np.real(h.best_rho),
            "best_rho_im": np.imag(h.best_rho),
            "best_mask": np.asarray(h.best_mask),
            "best_err": np.asarray(h.best_err),
            "last_err": np.asarray(h.last_err),
            "errors": np.concatenate([np.asarray(e) for e in errors_list],
                                     axis=1)
            if errors_list else np.zeros((0, 0, 2), dtype=np.float32),
        }
        if h.err_snapshot is not None:  # mid-loop SNAPSHOT (reset-to-best)
            data["err_snapshot"] = np.asarray(h.err_snapshot)
        if h.enforce_hist is not None:  # dynamic ft_stab shift register
            data["enforce_hist"] = np.asarray(h.enforce_hist)
        tmp = self.checkpoint_path + ".tmp"
        os.makedirs(os.path.dirname(os.path.abspath(tmp)), exist_ok=True)
        hdf5_io.save(tmp, data)
        os.replace(tmp, self.checkpoint_path)

    def _load(self):
        from xframe_tpu.io import hdf5 as hdf5_io
        from xframe_tpu.projects.fxs.phasing import PhasingState
        if not (self.checkpoint_path and os.path.exists(self.checkpoint_path)):
            return None, 0, []
        d = hdf5_io.load(self.checkpoint_path)
        cdtype, rdtype = self.mtip.cdtype, self.mtip.rdtype

        def cplx(name):
            return jnp.asarray(np.asarray(d[name + "_re"])
                               + 1j * np.asarray(d[name + "_im"]),
                               dtype=cdtype)

        state = PhasingState(
            rho=cplx("rho"),
            support=jnp.asarray(np.asarray(d["support"]), dtype=bool),
            best_rho=cplx("best_rho"),
            best_mask=jnp.asarray(np.asarray(d["best_mask"]), dtype=bool),
            best_err=jnp.asarray(d["best_err"], dtype=rdtype),
            last_err=jnp.asarray(d["last_err"], dtype=rdtype),
            err_snapshot=jnp.asarray(d["err_snapshot"], dtype=rdtype)
            if "err_snapshot" in d else None)
        if "anchor_rho_re" in d:
            state = self._best_from_anchor(d, state)
        if "enforce_hist" in d:          # dynamic ft_stab shift register
            state = state._replace(
                enforce_hist=jnp.asarray(np.asarray(d["enforce_hist"]),
                                         dtype=bool))
        prev = np.asarray(d["errors"], dtype=np.float32)
        errors = [prev] if prev.ndim == 3 and prev.shape[1] > 0 else []
        return state, int(d["chunk_index"]), errors

    def _best_from_anchor(self, d, state):
        """Checkpoints written by the former replay best tracking hold the
        best iterate as an anchor (a state on the trajectory, its support and
        global iteration index) plus the number of iterations to replay from
        it; their best_rho field is a placeholder. Rebuild best_rho/best_mask
        by replaying those iterations with the plain MTIP step."""
        mtip = self.mtip
        steps = _iteration_table(self.schedule)
        anchor = np.asarray(d["anchor_rho_re"]) \
            + 1j * np.asarray(d["anchor_rho_im"])
        sup = np.asarray(d["anchor_sup"]) > 0
        start = np.atleast_1d(np.asarray(d["anchor_start"], dtype=int))
        length = np.atleast_1d(np.asarray(d["anchor_len"], dtype=int))
        gates = np.atleast_1d(np.asarray(d["anchor_gate"], dtype=np.float64)
                              if "anchor_gate" in d
                              else np.ones(len(start)))
        step = jax.jit(lambda r, s, b, g, m, f: mtip.mtip_iteration(
            r, s, b, m, f, ft_gate=g)[0], static_argnums=(4, 5))
        best = []
        for i in range(len(start)):
            rho = jnp.asarray(anchor[i], dtype=mtip.cdtype)
            for k in range(int(length[i])):
                method, beta, fts, link = steps[int(start[i]) + k]
                gate = jnp.asarray(gates[i], mtip.rdtype) if link else None
                rho = step(rho, jnp.asarray(sup[i]),
                           jnp.asarray(beta, mtip.rdtype), gate, method, fts)
            best.append(rho)
        return state._replace(best_rho=jnp.stack(best),
                              best_mask=jnp.asarray(sup))

    # ------------------------------------------------------------------ run
    def __call__(self, rho0_batch, resume=True, max_chunks=None):
        """max_chunks limits how many chunks run this call (the snapshot
        still lands, so a later call resumes where this one stopped)."""
        n_out = int(rho0_batch.shape[0])
        rho0_batch = _pad_restarts(rho0_batch, self._n_shards)
        if self.in_sharding is not None:
            rho0_batch = jax.device_put(rho0_batch, self.in_sharding)
        state, start_chunk, errors = (None, 0, [])
        if resume and self.checkpoint_path:
            state, start_chunk, errors = self._load()
        if state is None:
            state = self._init_state(rho0_batch, self._init_support)
            start_chunk, errors = 0, []
        stop = len(self.chunks) if max_chunks is None \
            else min(start_chunk + int(max_chunks), len(self.chunks))
        for i in range(start_chunk, stop):
            structure, args = _chunk_structure_args(self.chunks[i])
            state, errs = self._step(structure)(state, args, self._tables)
            errors.append(errs)
            if self.checkpoint_path and ((i + 1) % self.save_every == 0
                                         or i == stop - 1):
                jax.block_until_ready(state.rho)
                self._save(state, errors, i + 1)
        all_errors = jnp.concatenate(
            [jnp.asarray(e) for e in errors], axis=1) if errors \
            else jnp.zeros((len(rho0_batch), 0, 2))
        if int(len(rho0_batch)) != n_out:
            state = jax.tree.map(lambda x: x[:n_out], state)
            all_errors = all_errors[:n_out]
        return state, all_errors
