"""Process-parallel shard execution for the routing plane.

:class:`repro_torch.engine.router.FleetRouter` runs its shards inline —
each shard is an independent :class:`~repro_torch.engine.fleet.FleetEngine`
with its own scheduler and packed plane, so nothing stops them draining in
parallel.  This module supplies the parallel runner: a :class:`ShardHost`
is one shard living in its own OS process (spawned, never forked), driven
over a pipe by a tiny command protocol, and a :class:`ProcessShardSet` is
N hosts behind the same consistent-hash placement the inline router uses
(:func:`repro_torch.engine.router.shard_ids_for` + the
:class:`~repro_torch.engine.placement.PartitionDirectory`), presenting the
same submit/drain/stats EventSink surface.  ``drain`` is split-phase —
every host is told to drain before any is waited on — so shard work
overlaps.

The spawn rule: **the parent builds, the workers compute, and engines
cross as host data.**

* Tenant engines are built *inside* the worker from picklable zero-arg
  factories (module-level functions / :func:`functools.partial`), on the
  device each factory names (the port's default is the card; a factory
  that cannot reach its device fails the worker, which raises
  :class:`ShardHostError` here — nothing falls back to the CPU).
* Before spawning, the parent compiles every kernel once when a card is
  present (:func:`repro_torch.kernels._backend.build`: ``nvcc`` only, no
  CUDA context), so the workers load built libraries instead of each
  starting its own compilers.
* Everything on the pipe is a :func:`pickle.dumps` byte string
  (``Connection.send_bytes``), never a ``multiprocessing`` pickle: with
  torch imported, that pickler would pass CUDA tensors as IPC handles
  and CPU tensors as shared memory.  Results and stats are pickled with
  every tensor staged to the host.  A migrating engine is written whole
  by its source worker to a file in the temporary directory
  (``torch.save``: each storage once, device storages in one copy to the
  host) and read by the target worker, where its tensors land on the
  device they left; the parent relays only the path and never unpickles
  a tensor, so it never creates a CUDA context.
"""
from __future__ import annotations

import io
import multiprocessing as mp
import os
import pickle
import tempfile
import traceback
from typing import Callable, Dict, List, Mapping, Optional

from repro_torch.engine.compute import BACKENDS
from repro_torch.engine.placement import HashRing, PartitionDirectory
from repro_torch.engine.router import shard_ids_for
from repro_torch.engine.scheduler import SchedulerSpec


def _host_bytes(obj) -> bytes:
    """``obj`` pickled with every tensor staged to the host."""
    import torch

    class HostPickler(pickle.Pickler):
        def reducer_override(self, o):
            if isinstance(o, torch.Tensor) and o.device.type != "cpu":
                return o.cpu().__reduce_ex__(pickle.HIGHEST_PROTOCOL)
            return NotImplemented

    buf = io.BytesIO()
    HostPickler(buf, protocol=pickle.HIGHEST_PROTOCOL).dump(obj)
    return buf.getvalue()


def _spool_engine(engine, inbox) -> str:
    """Write a detached engine and its queued events to a file in the
    temporary directory; returns its path.  ``torch.save`` writes each
    tensor storage once (views stay views of one storage) and a device
    storage in one copy to the host.  A file, not the pipe: an engine
    holds its table, hundreds of megabytes at full width, and a pipe can
    move that a thousand times slower than a file (see PERF.md)."""
    import torch
    fd, path = tempfile.mkstemp(prefix="shard-engine-", suffix=".pt")
    with os.fdopen(fd, "wb") as f:
        torch.save((engine, inbox), f)
    return path


def _unspool_engine(path: str):
    """The inverse of :func:`_spool_engine`, in the target worker (tensors
    land on the device they left); the file is removed."""
    import torch
    try:
        return torch.load(path, weights_only=False)
    finally:
        os.remove(path)


def _kernel_launches(reset: bool) -> Dict[str, int]:
    """This process's launch count of each fleet kernel wrapper (CPU calls
    count none), zeroed after reading when ``reset``."""
    from repro_torch.kernels.decision_fused import decision_fused
    from repro_torch.kernels.fleet_scan import fleet_scan
    from repro_torch.kernels.move_score import move_score
    from repro_torch.kernels.pruning import pruning
    wrappers = {"pruning": pruning.scan_matrix,
                "fleet_scan": fleet_scan.scan_fleet,
                "decision_fused": decision_fused.fused_decision,
                "move_score": move_score.move_scores}
    out = {name: w.launches for name, w in wrappers.items()}
    if reset:
        for w in wrappers.values():
            w.launches = 0
    return out


def _send(conn, obj) -> None:
    conn.send_bytes(pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL))


def _recv(conn):
    return pickle.loads(conn.recv_bytes())


def _shard_worker(conn, factories: Dict[str, Callable],
                  spec: SchedulerSpec, name: str,
                  incremental: Optional[bool]) -> None:
    """Worker main loop: build the shard fleet, serve commands until EOF."""
    from repro_torch.engine.fleet import FleetEngine

    try:
        tenants = {tid: factory() for tid, factory in factories.items()}
        fleet = FleetEngine(tenants, spec.build(), name=name,
                            incremental=incremental)
        conn.send_bytes(_host_bytes(("ok", None)))
    except BaseException:
        conn.send_bytes(_host_bytes(("err", traceback.format_exc())))
        return
    while True:
        try:
            cmd, payload = _recv(conn)
        except EOFError:
            return
        try:
            if cmd == "submit_many":
                for ev in payload:
                    fleet.submit(ev)
                result = len(payload)
            elif cmd == "drain":
                result = fleet.drain(**payload)
            elif cmd == "result":
                result = fleet.result(payload)
            elif cmd == "stats":
                result = fleet.stats()
            elif cmd == "queue_depth":
                result = fleet.queue_depth
            elif cmd == "migrate_out":
                inbox = fleet.take_inbox(payload)
                engine = fleet.remove_tenant(payload)
                result = _spool_engine(engine, inbox)
            elif cmd == "migrate_in":
                tid, path = payload
                engine, inbox = _unspool_engine(path)
                fleet.add_tenant(tid, engine)
                for ev in inbox:
                    fleet.submit(ev)
                result = None
            elif cmd == "kernel_launches":
                result = _kernel_launches(payload)
            elif cmd == "max_memory_allocated":
                import torch
                result = (torch.cuda.max_memory_allocated()
                          if torch.cuda.is_initialized() else 0)
            elif cmd == "close":
                conn.send_bytes(_host_bytes(("ok", None)))
                return
            else:
                raise ValueError(f"unknown shard command {cmd!r}")
            conn.send_bytes(_host_bytes(("ok", result)))
        except BaseException:
            conn.send_bytes(_host_bytes(("err", traceback.format_exc())))


class ShardHostError(RuntimeError):
    """A shard worker raised; carries the worker-side traceback."""


class ShardHost:
    """One fleet shard behind a spawned worker process.

    Submits buffer in the parent and flush with the next drain (one
    pipe round trip per drain, not per event).  All calls are
    synchronous except the :meth:`start_drain` / :meth:`finish_drain`
    pair, which :class:`ProcessShardSet` uses to overlap shard drains.
    """

    def __init__(self, shard_id: str, factories: Mapping[str, Callable],
                 spec: SchedulerSpec, name: Optional[str] = None,
                 incremental: Optional[bool] = None,
                 mp_context: str = "spawn"):
        self.shard_id = shard_id
        ctx = mp.get_context(mp_context)
        self._conn, child = ctx.Pipe()
        self._proc = ctx.Process(
            target=_shard_worker,
            args=(child, dict(factories), spec, name or shard_id,
                  incremental),
            daemon=True)
        self._proc.start()
        child.close()
        self._outbox: List = []
        self._busy = False          # a start_drain awaiting finish_drain

    def _recv(self):
        try:
            status, payload = _recv(self._conn)
        except EOFError:
            raise ShardHostError(f"shard {self.shard_id!r} worker exited "
                                 f"(exit code {self._proc.exitcode})")
        if status != "ok":
            raise ShardHostError(
                f"shard {self.shard_id!r} worker failed:\n{payload}")
        return payload

    def _call(self, cmd: str, payload=None):
        if self._busy:
            raise RuntimeError("finish_drain() the in-flight drain first")
        _send(self._conn, (cmd, payload))
        return self._recv()

    def wait_ready(self) -> None:
        """Wait for the worker's construction handshake."""
        self._recv()

    # -- EventSink-ish surface -----------------------------------------
    def submit(self, event) -> None:
        self._outbox.append(event)

    @property
    def queue_depth(self) -> int:
        return len(self._outbox) + self._call("queue_depth")

    def flush_submits(self) -> int:
        if not self._outbox:
            return 0
        out, self._outbox = self._outbox, []
        return self._call("submit_many", out)

    def start_drain(self, **kwargs) -> None:
        """Flush buffered submits and tell the worker to drain (async)."""
        self.flush_submits()
        _send(self._conn, ("drain", kwargs))
        self._busy = True

    def finish_drain(self) -> int:
        self._busy = False
        return self._recv()

    def drain(self, **kwargs) -> int:
        self.start_drain(**kwargs)
        return self.finish_drain()

    def result(self, name: Optional[str] = None):
        return self._call("result", name)

    def stats(self) -> dict:
        return self._call("stats")

    def max_memory_allocated(self) -> int:
        """The worker's peak CUDA allocation in bytes (0 without one)."""
        return self._call("max_memory_allocated")

    def kernel_launches(self, reset: bool = False) -> Dict[str, int]:
        """The worker's kernel launches by kernel (zeroed when ``reset``)."""
        return self._call("kernel_launches", reset)

    def migrate_out(self, tenant_id: str) -> str:
        """Detach a tenant; returns the file its engine and queued events
        were written to (see :meth:`migrate_in`)."""
        return self._call("migrate_out", tenant_id)

    def migrate_in(self, tenant_id: str, path: str) -> None:
        """Attach the tenant written to ``path`` (the file is removed)."""
        self._call("migrate_in", (tenant_id, path))

    def close(self) -> None:
        if self._proc.is_alive():
            try:
                self._busy = False
                self._call("close")
            except (ShardHostError, OSError, EOFError):
                pass
            self._proc.join(timeout=10)
            if self._proc.is_alive():
                self._proc.kill()
                self._proc.join()
        self._conn.close()


class ProcessShardSet:
    """N process-resident shards behind the router's placement.

    Same consistent-hash tenant→shard mapping as an inline
    :class:`repro_torch.engine.router.FleetRouter` with the same shard
    count and ``replicas`` — the two agree on every tenant's home, so a
    deployment can switch runners without a placement migration.
    Context-manage it (or call :meth:`close`) to reap the workers.
    ``drain`` takes :meth:`FleetEngine.drain`'s arguments (its default
    lane is ``"decision_fused"``).
    """

    def __init__(self, factories: Mapping[str, Callable],
                 num_shards: int = 2,
                 scheduler: Optional[SchedulerSpec] = None,
                 name: str = "procset",
                 replicas: int = 64,
                 incremental: Optional[bool] = None,
                 mp_context: str = "spawn"):
        if not factories:
            raise ValueError("a shard set needs at least one tenant factory")
        import torch
        if torch.cuda.is_available():
            # nvcc only, no CUDA context: the workers load what it built.
            from repro_torch.kernels import _backend
            _backend.build()
        self.name = name
        spec = scheduler or SchedulerSpec.unlimited()
        self.ring = HashRing(shard_ids_for(num_shards), replicas=replicas)
        self.directory = PartitionDirectory(self.ring)
        by_shard: Dict[str, Dict[str, Callable]] = {
            sid: {} for sid in self.ring.shard_ids}
        for tid, factory in factories.items():
            by_shard[self.directory.lookup(tid)][tid] = factory
        self._hosts: Dict[str, ShardHost] = {}
        try:
            for sid in self.ring.shard_ids:
                self._hosts[sid] = ShardHost(
                    sid, by_shard[sid], spec, name=f"{name}/{sid}",
                    incremental=incremental, mp_context=mp_context)
            # Every worker builds its tenants at once; then the handshakes.
            for host in self._hosts.values():
                host.wait_ready()
        except BaseException:
            self.close()
            raise
        self._known = set(factories)
        self.migrations = 0

    def __enter__(self) -> "ProcessShardSet":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    @property
    def shard_ids(self) -> List[str]:
        return self.ring.shard_ids

    def shard_of(self, tenant_id: str) -> str:
        if tenant_id not in self._known:
            raise KeyError(f"unknown tenant {tenant_id!r}")
        return self.directory.lookup(tenant_id)

    def host(self, shard_id: str) -> ShardHost:
        return self._hosts[shard_id]

    # -- EventSink surface ---------------------------------------------
    def submit(self, event) -> None:
        from repro_torch.core import workload as wl
        ev = wl.as_event(event)
        self._hosts[self.shard_of(ev.tenant_id)].submit(ev)

    @property
    def queue_depth(self) -> int:
        return sum(h.queue_depth for h in self._hosts.values())

    def drain(self, **kwargs) -> int:
        """Drain all shards concurrently (split-phase over the workers)."""
        kwargs.pop("collect", None)     # per-event observations stay local
        compute = kwargs.get("compute", "decision_fused")
        if compute not in BACKENDS:
            raise ValueError(f"unknown compute lane {compute!r} (expected "
                             f"one of {BACKENDS})")
        for sid in self.ring.shard_ids:
            self._hosts[sid].start_drain(**kwargs)
        return sum(self._hosts[sid].finish_drain()
                   for sid in self.ring.shard_ids)

    def stats(self) -> dict:
        return {
            "name": self.name,
            "num_shards": len(self._hosts),
            "tenants": len(self._known),
            "migrations": self.migrations,
            "shards": {sid: self._hosts[sid].stats()
                       for sid in self.ring.shard_ids},
        }

    def result(self, name: Optional[str] = None):
        from repro_torch.engine.fleet import FleetResult
        per_tenant = {}
        ticks = deferred = deferred_ticks = 0
        shard_stats = {}
        sched_name = ""
        for sid in self.ring.shard_ids:
            r = self._hosts[sid].result()
            per_tenant.update(r.per_tenant)
            ticks += r.ticks
            deferred += r.swaps_deferred
            deferred_ticks += r.deferred_ticks
            shard_stats[sid] = r.scheduler_stats
            sched_name = r.scheduler
        return FleetResult(name=name or self.name, scheduler=sched_name,
                           per_tenant=per_tenant, ticks=ticks,
                           swaps_deferred=deferred,
                           deferred_ticks=deferred_ticks,
                           scheduler_stats={"shards": shard_stats})

    def migrate_tenant(self, tenant_id: str, target_shard: str) -> bool:
        """Engine + queued events, written to a file by the source worker
        and read by the target worker; the parent relays only its path."""
        if target_shard not in self._hosts:
            raise KeyError(f"unknown shard {target_shard!r}")
        source_shard = self.shard_of(tenant_id)
        if source_shard == target_shard:
            return False
        # Parent-side buffered submits must reach the worker inbox first,
        # or migrate_out would miss them.
        self._hosts[source_shard].flush_submits()
        path = self._hosts[source_shard].migrate_out(tenant_id)
        self._hosts[target_shard].migrate_in(tenant_id, path)
        self.directory.assign(tenant_id, target_shard)
        self.migrations += 1
        return True

    def close(self) -> None:
        for host in self._hosts.values():
            host.close()
        self._hosts = {}


__all__ = ["ProcessShardSet", "ShardHost", "ShardHostError"]
