"""Mesh-sharded serving (counterpart of paddle_tpu/serving/mesh.py).

The JAX package runs each decode, prefill and verify program as one
SPMD program over a device mesh from one controller. Here a rank is a
process (parallel/distributed.py), so a serving mesh is a group of rank
processes driven by the caller's process, which holds no rank itself:

- the caller (the controller) keeps every host decision: slots, page
  tables, prefix sharing, acceptance, scheduling. Its predictors talk to
  the ranks through a RemoteExecutor, one per predictor (clones and a
  speculative draft each have their own), which stands where the
  one-device Executor stands;
- the ranks (`worker_main`, spawned interpreters, never forks) meet in a
  process group of their own (gloo: ranks share a card or run on the
  CPU), so the caller can itself be a rank of a training job. They hold
  what the controller sent: the programs (Program.to_json), each
  predictor's K/V state and their part of each weight, and they run
  exactly the commands the controller sends, in order: run a program
  on feeds, zero the state, read or write page rows, take a weight,
  load a sharded checkpoint, report, close. A rank decides nothing;
- a run goes through MeshDecodeExecutor: every op by its layout rule
  (parallel/layout.py) with the K/V state stored heads-sharded
  (DecodeSpec.cache_spec), the feeds replicated and each weight under
  its serve spec (DecodeSpec.serve_param_specs: column-style only). The
  logits come out replicated on every rank; rank 0's are returned;
- one lock serialises a group's commands, so the predictors that share
  a group (clones, the draft, other predictors on the same mesh and
  place) never interleave theirs;
- the ranks die with the controller: at close() of the last predictor
  using the group, at exit, when the controller's socket closes, or
  when the controller process is gone (a rank watches its parent).

A 1-device mesh (all axes of size 1, spelled 'dp=1') runs in the
caller's process. A mesh run is eager: its collectives are host calls
under gloo, which a CUDA graph cannot capture (ROADMAP.md Queue 3).
"""
from __future__ import annotations

import atexit
import itertools
import os
import pickle
import shutil
import socket
import struct
import subprocess
import sys
import tempfile
import threading
import time
import traceback
import weakref

import numpy as np
import torch

from ..executor import Executor
from ..parallel.mesh import MeshConfig

__all__ = ['serving_mesh', 'mesh_shape_str', 'MeshDecodeExecutor',
           'RemoteExecutor', 'ServingGroup', 'group_for', 'open_station',
           'shutdown', 'worker_main']

# seconds a rank waits in a collective before gloo gives up
RANK_TIMEOUT = 600.0
# seconds the controller waits for the ranks to come up
START_TIMEOUT = 300.0


def mesh_shape_str(mesh):
    """Canonical 'ax=n,...' string of a built Mesh (the form stats and
    SRV_HEALTH carry)."""
    return ','.join('%s=%d' % (ax, n) for ax, n in mesh.shape.items())


def serving_mesh(mesh=None):
    """Resolve a prepare_decoding mesh argument -> (Mesh | None,
    shape_str). Accepts None (read FLAGS_serve_mesh_shape; '' keeps the
    one-device path), an axis-spec string ('tp=2'), a MeshConfig or a
    built Mesh."""
    from ..flags import get_flag
    if mesh is None:
        mesh = str(get_flag('serve_mesh_shape', '') or '').strip()
        if not mesh:
            return None, ''
    if isinstance(mesh, str):
        if not mesh.strip():
            return None, ''
        mesh = MeshConfig.from_spec(mesh)
    if isinstance(mesh, MeshConfig):
        mesh = mesh.build()
    return mesh, mesh_shape_str(mesh)


def local_shape(shape, spec, mesh):
    """A rank's shape of a value of global `shape` under `spec`."""
    from ..parallel.layout import factor, normalize
    return tuple(int(s) // factor(e, mesh) for s, e in
                 zip(shape, normalize(spec, len(shape), mesh)))


def assemble(parts, spec, mesh):
    """The whole value from every rank's part (rank order) under `spec`:
    each part is written at its region; replicas write the same bits."""
    from ..parallel.layout import factor, normalize
    first = parts[0]
    sp = normalize(spec, first.ndim, mesh)
    shape = [s * factor(e, mesh) for s, e in zip(first.shape, sp)]
    out = np.empty(shape, dtype=first.dtype)
    for r, part in enumerate(parts):
        coord = mesh.coordinate(r)
        region = []
        for d, axes in enumerate(sp):
            idx = 0
            for a in axes:
                idx = idx * mesh.shape[a] + coord[a]
            n = part.shape[d]
            region.append(slice(idx * n, (idx + 1) * n))
        out[tuple(region)] = part
    return out


def _split(value, spec, mesh):
    """Every rank's part of a whole host value under `spec`."""
    from ..parallel.layout import local_part, normalize
    t = value if isinstance(value, torch.Tensor) else \
        torch.from_numpy(np.ascontiguousarray(value))
    t = t.detach().cpu()
    sp = normalize(spec, t.ndim, mesh)
    return [_host(local_part(t, sp, mesh, r).contiguous())
            for r in range(mesh.size)]


def _host(t):
    """A CPU tensor as what goes on the wire: numpy where numpy has the
    dtype, else the tensor itself (bf16)."""
    if t.dtype == torch.bfloat16:
        return t.clone()
    return t.numpy()


# -- framing ------------------------------------------------------------------
#
# A message is a pickle with its large buffers out of band (protocol 5):
# a header (pickle length, buffer count, each buffer's length), the
# pickle, then each buffer raw, so a weight's bytes are copied once on
# each side of the socket, not through the pickle stream.

def _pack(msg):
    bufs = []
    data = pickle.dumps(msg, protocol=5, buffer_callback=bufs.append)
    return data, [b.raw() for b in bufs]


def _send(sock, packed):
    data, bufs = packed
    sock.sendall(struct.pack('<QI%dQ' % len(bufs), len(data), len(bufs),
                             *(b.nbytes for b in bufs)))
    sock.sendall(data)
    for b in bufs:
        sock.sendall(b)


def _recv(sock):
    n, k = struct.unpack('<QI', _recv_exact(sock, 12))
    sizes = struct.unpack('<%dQ' % k, _recv_exact(sock, 8 * k))
    data = _recv_exact(sock, n)
    return pickle.loads(data, buffers=[_recv_exact(sock, s)
                                       for s in sizes])


def _recv_exact(sock, n):
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        k = sock.recv_into(view[got:], min(n - got, 1 << 24))
        if not k:
            raise ConnectionError('the peer closed the connection')
        got += k
    return buf


# -- a rank -------------------------------------------------------------------

class MeshDecodeExecutor(Executor):
    """An Executor whose runs go over a serving mesh, on this rank's
    shards: the state vars stored under their spec (the K/V state's
    heads over tp), each weight under its serve spec, every feed
    replicated. `storage` maps var name -> spec (tuple form). Runs are
    eager; the fetched values come back whole."""

    def __init__(self, place, mesh, rank, storage):
        super(MeshDecodeExecutor, self).__init__(place)
        self.mesh = mesh
        self.rank = int(rank)
        self._storage = dict(storage)
        self._records = []
        self._wall = 0.0

    def storage_spec(self, name):
        return self._storage.get(name)

    def run(self, program=None, feed=None, fetch_list=None, scope=None,
            return_numpy=True, **unused):
        from ..parallel import collectives as C
        from ..parallel.layout import DistState
        t0 = time.perf_counter()
        feed = feed or {}
        fetch_names = [getattr(v, 'name', v) for v in (fetch_list or [])]
        local = {n: self._feed_tensor(program, n, v)
                 for n, v in feed.items()}
        prepared = self._cached_prepared(program, local, fetch_names, scope)
        st = DistState(self.mesh, self.rank, self._storage, ())
        with C.recording() as recs:
            results = self._run_prepared(prepared, local, scope, program,
                                         False, dist=st)
            out = [self._whole(n, v, st)
                   for n, v in zip(fetch_names, results)]
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)
        self._records = recs
        self._wall = time.perf_counter() - t0
        if return_numpy:
            return [v.detach().cpu().numpy() for v in out]
        return out

    def _whole(self, name, value, st):
        from ..parallel import collectives as C
        if not isinstance(value, torch.Tensor):
            return value
        spec = st.spec_for(name, value)
        for d in range(len(spec)):
            for a in reversed(spec[d]):
                value = C.gather(value, d, C.axis(self.mesh, a))
        return value

    def last_run(self):
        """The last run's wall seconds on this rank and its collectives'
        record (parallel/collectives.py)."""
        return {'wall': self._wall, 'records': list(self._records)}


class _Rank(object):
    """What one rank holds and does: weight sets, stations (a predictor's
    state Scope and its MeshDecodeExecutor), programs."""

    def __init__(self, rank, mesh, place):
        self.rank, self.mesh, self.place = rank, mesh, place
        self.weights = {}      # wid -> Scope
        self.wspecs = {}       # wid -> {name: spec}
        self.stations = {}     # sid -> (executor, scope, state names)
        self.programs = {}     # key -> Program
        self.switches = None

    def _tensor(self, value):
        t = value if isinstance(value, torch.Tensor) else \
            torch.from_numpy(np.ascontiguousarray(value))
        return t.to(self.place.device)

    # the commands
    def weight(self, wid, name, value, spec):
        from ..executor import Scope
        scope = self.weights.setdefault(wid, Scope())
        self.wspecs.setdefault(wid, {})[name] = spec
        scope.set_var(name, self._tensor(value))

    def station(self, sid, wid, names, shape, spec):
        from ..executor import Scope
        storage = dict(self.wspecs.get(wid, {}))
        storage.update({n: spec for n in names})
        exe = MeshDecodeExecutor(self.place, self.mesh, self.rank, storage)
        scope = Scope(parent=self.weights[wid])
        for n in names:
            scope.set_var(n, torch.zeros(local_shape(shape, spec, self.mesh),
                                         dtype=torch.float32,
                                         device=self.place.device))
        self.stations[sid] = (exe, scope, list(names))

    def drop(self, sids, wids):
        for sid in sids:
            self.stations.pop(sid, None)
        for wid in wids:
            self.weights.pop(wid, None)
            self.wspecs.pop(wid, None)
        if self.place.device.type == 'cuda':
            torch.cuda.empty_cache()

    def program(self, key, text, is_test, use_bf16):
        from ..framework import Program
        prog = Program.from_json(text)
        prog._is_test = bool(is_test)
        prog._use_bf16 = bool(use_bf16)
        self.programs[key] = prog

    def run(self, sid, key, feed, fetch_names, switches):
        if switches != self.switches:
            from ..flags import set_flags
            (fwd, bwd), flags = switches
            for name, val in (('PADDLE_FLASH_FWD', fwd),
                              ('PADDLE_FLASH_BWD', bwd)):
                if val:
                    os.environ[name] = val
                else:
                    os.environ.pop(name, None)
            set_flags(dict(flags))
            self.switches = switches
        exe, scope, _ = self.stations[sid]
        out = exe.run(self.programs[key], feed=feed, fetch_list=fetch_names,
                      scope=scope)
        return out if self.rank == 0 else None

    def zero(self, sid):
        _, scope, names = self.stations[sid]
        for n in names:
            scope.find_var(n).zero_()

    def rows(self, sid, ids):
        _, scope, names = self.stations[sid]
        out = []
        for n in names:
            pool = scope.find_var(n)
            sel = torch.as_tensor(ids, dtype=torch.long, device=pool.device)
            out.append(pool.index_select(0, sel).cpu().numpy())
        return out

    def write_rows(self, sid, ids, data):
        _, scope, names = self.stations[sid]
        for n, host in zip(names, data):
            pool = scope.find_var(n)
            sel = torch.as_tensor(ids, dtype=torch.long, device=pool.device)
            pool.index_copy_(0, sel, self._tensor(host).to(pool.dtype))

    def install(self, wid, name, value):
        cur = self.weights[wid].find_var(name)
        self.weights[wid].set_var(name, self._tensor(value).to(cur.dtype))

    def load_sharded(self, wid, root, specs):
        from ..checkpoint import restore
        ckpt = restore.load_checkpoint(root)
        scope = self.weights[wid]
        for name, spec in specs.items():
            cur = scope.find_var(name)
            val = ckpt.as_torch(name, self.mesh, spec=spec, rank=self.rank,
                                device=self.place.device)
            scope.set_var(name, val.to(cur.dtype).contiguous())

    def weights_out(self, wid, names):
        scope = self.weights[wid]
        return [_host(scope.find_var(n).detach().cpu().contiguous())
                for n in names]

    def layout(self, sid):
        exe, scope, names = self.stations[sid]
        return {'spec': exe.storage_spec(names[0]) if names else None,
                'shapes': [tuple(scope.find_var(n).shape) for n in names]}

    def weight_shapes(self, wid, names):
        scope = self.weights[wid]
        return [tuple(scope.find_var(n).shape) for n in names]

    def stats(self, sid):
        exe = self.stations[sid][0]
        return dict(exe.jit_cache_stats(), **exe.last_run())

    def call(self, path, args, kwargs):
        import importlib
        mod, _, fn = path.partition(':')
        return getattr(importlib.import_module(mod), fn)(*args, **kwargs)


_CURRENT = None


def rank_memory(reset=False):
    """This rank's device memory: peak allocated and reserved bytes (a
    `call` target for the chip script)."""
    r = _CURRENT
    if r is None or r.place.device.type != 'cuda':
        return {'allocated': 0, 'reserved': 0}
    out = {'allocated': int(torch.cuda.max_memory_allocated()),
           'reserved': int(torch.cuda.max_memory_reserved())}
    if reset:
        torch.cuda.reset_peak_memory_stats()
    return out


def _watch_parent(ppid):
    while True:
        time.sleep(0.5)
        if os.getppid() != ppid:
            os._exit(3)


def worker_main():
    """A rank of a serving group (started by ServingGroup with its
    address, rank and mesh in PADDLE_SERVE_MESH_* variables): join the
    ranks' process group, then run the controller's commands until it
    says close or goes away."""
    global _CURRENT
    env = os.environ
    rank = int(env['PADDLE_SERVE_MESH_RANK'])
    world = int(env['PADDLE_SERVE_MESH_WORLD'])
    shape = env['PADDLE_SERVE_MESH_SHAPE']
    place_name = env['PADDLE_SERVE_MESH_PLACE']
    host, port = env['PADDLE_SERVE_MESH_ADDR'].rsplit(':', 1)
    key = bytes.fromhex(env['PADDLE_SERVE_MESH_KEY'])
    threading.Thread(target=_watch_parent,
                     args=(int(env['PADDLE_SERVE_MESH_PPID']),),
                     daemon=True).start()
    sock = socket.create_connection((host, int(port)))
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    _send(sock, _pack(('hello', key, rank)))
    try:
        from .. import executor as E
        from ..parallel import distributed as D
        torch.backends.cuda.matmul.allow_tf32 = \
            env.get('PADDLE_SERVE_MESH_TF32', '0') == '1'
        torch.backends.cudnn.allow_tf32 = \
            env.get('PADDLE_SERVE_MESH_CUDNN_TF32', '0') == '1'
        place = E.CPUPlace() if place_name == 'cpu' else \
            E.CUDAPlace(int(place_name.split(':')[1]))
        D.init_parallel_env(trainer_id=rank, num_trainers=world,
                            init_method=env['PADDLE_SERVE_MESH_STORE'],
                            use_cuda=place_name != 'cpu')
        mesh = MeshConfig.from_spec(shape).build()
        mesh.devices = [place] * world
        if world > 1:
            mesh.device_mesh          # every rank builds it, in order
        _CURRENT = _Rank(rank, mesh, place)
        reply = ('ok', None)
    except Exception:
        reply = ('error', traceback.format_exc())
    _send(sock, _pack(reply))
    if reply[0] != 'ok':
        os._exit(1)
    while True:
        try:
            msg = _recv(sock)
        except (ConnectionError, OSError):
            os._exit(2)
        cmd, args = msg[0], msg[1:]
        if cmd == 'close':
            _send(sock, _pack(('ok', None)))
            sock.close()
            os._exit(0)
        try:
            reply = ('ok', getattr(_CURRENT, cmd)(*args))
        except Exception:
            reply = ('error', traceback.format_exc())
        try:
            _send(sock, _pack(reply))
        except (ConnectionError, OSError):
            os._exit(2)


# -- the controller's side ----------------------------------------------------

class MeshRankError(RuntimeError):
    """A rank of a serving group failed; the group is closed."""


class _WeightSet(object):
    """The weights of one scope on a group's ranks: their id there, the
    spec each uploaded weight was split by, the stations using them."""

    def __init__(self, wid, scope):
        self.wid, self.scope = wid, scope
        self.specs = {}
        self.stations = 0


class ServingGroup(object):
    """The rank processes of one serving mesh on one place, driven by
    this process. Predictors attach stations (their state and executor
    on every rank); the group closes when the last one is released."""

    def __init__(self, mesh, place):
        self.mesh = mesh
        self.shape = mesh_shape_str(mesh)
        self.place = place
        self.size = int(mesh.size)
        self._lock = threading.RLock()
        self._ids = itertools.count(1)
        self._programs = {}       # id(program) -> (key, program)
        self._wsets = {}          # id(scope) -> _WeightSet
        self._stations = {}       # sid -> its _WeightSet
        self._released = []       # sids whose predictor was collected
        self._opening = 0         # stations being opened
        self._closed = False
        self._dir = tempfile.mkdtemp(prefix='serve_mesh_')
        self._procs, self._socks = [], []
        try:
            self._start()
        except BaseException:
            self.close()
            raise

    # -- start and stop --------------------------------------------------------
    def _start(self):
        key = os.urandom(16)
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.bind(('127.0.0.1', 0))
        srv.listen(self.size)
        srv.settimeout(1.0)
        pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        dev = self.place.device
        place_name = 'cpu' if dev.type == 'cpu' else 'cuda:%d' % (
            dev.index or 0)
        base = dict(os.environ)
        base['PYTHONPATH'] = os.pathsep.join(
            [pkg_root] + [p for p in base.get('PYTHONPATH', '').split(
                os.pathsep) if p])
        base.update({
            'PADDLE_SERVE_MESH_WORLD': str(self.size),
            'PADDLE_SERVE_MESH_SHAPE': self.shape,
            'PADDLE_SERVE_MESH_PLACE': place_name,
            'PADDLE_SERVE_MESH_ADDR': '127.0.0.1:%d' % srv.getsockname()[1],
            'PADDLE_SERVE_MESH_KEY': key.hex(),
            'PADDLE_SERVE_MESH_PPID': str(os.getpid()),
            'PADDLE_SERVE_MESH_STORE': 'file://' + os.path.join(
                self._dir, 'store'),
            'PADDLE_SERVE_MESH_TF32':
                '1' if torch.backends.cuda.matmul.allow_tf32 else '0',
            'PADDLE_SERVE_MESH_CUDNN_TF32':
                '1' if torch.backends.cudnn.allow_tf32 else '0'})
        base.setdefault('PADDLE_DIST_TIMEOUT', str(RANK_TIMEOUT))
        if dev.type == 'cpu':
            base.setdefault('OMP_NUM_THREADS', '1')
        for name in ('PADDLE_TRAINER_ID', 'PADDLE_TRAINERS_NUM',
                     'PADDLE_TRAINERS', 'PADDLE_TRAINER_ENDPOINTS',
                     'PADDLE_DIST_INIT_METHOD'):
            base.pop(name, None)
        for r in range(self.size):
            env = dict(base, PADDLE_SERVE_MESH_RANK=str(r))
            log = open(os.path.join(self._dir, 'rank%d.log' % r), 'wb')
            self._procs.append(subprocess.Popen(
                [sys.executable, '-c', 'from paddle_tpu_torch.serving.mesh '
                 'import worker_main; worker_main()'],
                env=env, stdin=subprocess.DEVNULL, stdout=log,
                stderr=subprocess.STDOUT))
            log.close()
        socks = [None] * self.size
        deadline = time.time() + START_TIMEOUT
        try:
            while any(s is None for s in socks):
                if time.time() > deadline:
                    raise MeshRankError('serving mesh %s: the ranks did not '
                                        'connect in %.0f s%s'
                                        % (self.shape, START_TIMEOUT,
                                           self._logs()))
                self._check_alive()
                try:
                    conn, _ = srv.accept()
                except socket.timeout:
                    continue
                conn.settimeout(None)
                conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                tag, got, rank = _recv(conn)
                if tag != 'hello' or got != key:
                    conn.close()
                    continue
                socks[rank] = conn
        finally:
            srv.close()
        self._socks = socks
        self._replies('start')

    def _check_alive(self):
        for r, p in enumerate(self._procs):
            if p.poll() is not None:
                raise MeshRankError('serving mesh %s: rank %d exited with '
                                    'code %s%s' % (self.shape, r,
                                                   p.returncode,
                                                   self._logs()))

    def _logs(self, tail=3000):
        out = []
        for r in range(len(self._procs)):
            try:
                with open(os.path.join(self._dir, 'rank%d.log' % r),
                          'rb') as f:
                    text = f.read()[-tail:].decode('utf-8', 'replace')
            except OSError:
                continue
            if text.strip():
                out.append('\n--- rank %d:\n%s' % (r, text))
        return ''.join(out)

    def close(self):
        """Tell every rank to exit, and end those that do not."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            for s in self._socks:
                try:
                    _send(s, _pack(('close',)))
                except (OSError, AttributeError):
                    pass
            deadline = time.time() + 10.0
            for p in self._procs:
                try:
                    p.wait(max(0.1, deadline - time.time()))
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait()
            for s in self._socks:
                try:
                    s.close()
                except (OSError, AttributeError):
                    pass
            shutil.rmtree(self._dir, ignore_errors=True)
            if _GROUPS.get(self._key()) is self:
                del _GROUPS[self._key()]

    @property
    def closed(self):
        return self._closed

    def _key(self):
        return (self.shape, str(self.place.device))

    # -- commands --------------------------------------------------------------
    def _collect(self, payloads, what):
        """Send payloads[r] to rank r, then read every rank's reply."""
        for sock, m in zip(self._socks, payloads):
            _send(sock, m)
        return self._replies(what)

    def _replies(self, what):
        """Every rank's reply to `what`; a rank's failure closes the
        group and raises."""
        out, err = [], None
        for r, sock in enumerate(self._socks):
            try:
                status, val = _recv(sock)
            except (ConnectionError, OSError) as e:
                status, val = 'error', 'lost: %s' % e
            if status != 'ok' and err is None:
                err = (r, val)
            out.append(val)
        if err is not None:
            self.close()
            raise MeshRankError('serving mesh %s: rank %d failed in %s:\n%s%s'
                                % (self.shape, err[0], what, err[1],
                                   self._logs()))
        return out

    def command(self, *msg, per_rank=None):
        """Run one command on every rank (per_rank: a list of argument
        tuples, one a rank) and return every rank's reply."""
        with self._lock:
            self._flush_released()
            if self._closed:
                raise MeshRankError('serving mesh %s is closed' % self.shape)
            if per_rank is None:
                payload = _pack(msg)
                msgs = [payload] * self.size
            else:
                msgs = [_pack(msg + tuple(a)) for a in per_rank]
            return self._collect(msgs, msg[0])

    def program_key(self, program):
        """The ranks' key of `program`, sent to them at its first use."""
        with self._lock:
            got = self._programs.get(id(program))
            if got is not None and got[1] is program:
                return got[0]
            key = next(self._ids)
            self.command('program', key, program.to_json(),
                         bool(getattr(program, '_is_test', False)),
                         bool(getattr(program, '_use_bf16', False)))
            self._programs[id(program)] = (key, program)
            return key

    # -- weights and stations ----------------------------------------------------
    def _weight_set(self, scope):
        ws = self._wsets.get(id(scope))
        if ws is None or ws.scope is not scope:
            ws = self._wsets[id(scope)] = _WeightSet(next(self._ids), scope)
        return ws

    def upload(self, ws, names, specs):
        """Send every rank its part of each weight in `names` the set
        does not hold yet (whole values read from the set's scope)."""
        for name in names:
            if name in ws.specs:
                continue
            val = ws.scope.find_var(name)
            if val is None:
                raise RuntimeError(
                    'decode transpile references param %r that is not in '
                    'the predictor scope -- was the model loaded with '
                    'load_params=True?' % name)
            spec = specs.get(name)
            self.command('weight', ws.wid, name, per_rank=[
                (p, spec) for p in _split(val, spec, self.mesh)])
            ws.specs[name] = spec

    def station(self, weight_scope, specs, names, state_names, state_shape,
                state_spec, place, owner):
        """A predictor's station on every rank: its weights uploaded (once
        a weight set), its state zeroed. Returns its RemoteExecutor."""
        with self._lock:
            if self._closed:
                raise MeshRankError('serving mesh %s is closed' % self.shape)
            self._opening += 1
            ws = self._weight_set(weight_scope)
            ws.stations += 1
            try:
                self.upload(ws, names, specs)
                sid = next(self._ids)
                self.command('station', sid, ws.wid, list(state_names),
                             tuple(state_shape), state_spec)
                self._stations[sid] = ws
            except BaseException:
                ws.stations -= 1
                raise
            finally:
                self._opening -= 1
            exe = RemoteExecutor(self, sid, ws, place, state_names,
                                 state_spec)
            weakref.finalize(owner, self._released.append, sid)
            return exe

    def release(self, sid):
        """Drop a station (a closed predictor's); the group closes with
        its last one."""
        with self._lock:
            if sid not in self._stations or self._closed:
                self._stations.pop(sid, None)
                return
            self._drop([sid])

    def _flush_released(self):
        if self._released and not self._closed:
            sids = [s for s in self._released if s in self._stations]
            del self._released[:]
            if sids:
                self._drop(sids)

    def _drop(self, sids):
        wids = []
        for sid in sids:
            ws = self._stations.pop(sid)
            ws.stations -= 1
            if ws.stations <= 0:
                wids.append(ws.wid)
                self._wsets.pop(id(ws.scope), None)
        if not self._stations and not self._opening:
            self.close()
            return
        payload = _pack(('drop', sids, wids))
        self._collect([payload] * self.size, 'drop')


_GROUPS = {}
_GROUPS_LOCK = threading.Lock()


def group_for(mesh, place):
    """The open ServingGroup of `mesh` on `place`, started if needed."""
    key = (mesh_shape_str(mesh), str(place.device))
    with _GROUPS_LOCK:
        g = _GROUPS.get(key)
        if g is None or g.closed:
            g = _GROUPS[key] = ServingGroup(mesh, place)
        return g


def open_station(mesh, place, *args):
    """A station (ServingGroup.station's arguments) on the open group of
    `mesh` on `place`: a group closed meanwhile is started anew."""
    for attempt in (0, 1):
        g = group_for(mesh, place)
        try:
            return g.station(*args)
        except MeshRankError:
            if attempt or not g.closed:
                raise


def shutdown():
    """Close every serving group of this process (also run at exit)."""
    for g in list(_GROUPS.values()):
        g.close()


atexit.register(shutdown)


class RemoteExecutor(object):
    """One predictor's executor on a serving mesh: Executor.run's
    signature, run by every rank of the group on its station. Fetches
    come back whole, as CPU tensors (numpy with return_numpy)."""

    def __init__(self, group, sid, ws, place, state_names, state_spec):
        self.group, self.sid = group, sid
        self._ws = ws
        self.place = place
        self.device = place.device
        self.mesh = group.mesh
        self.state_names = list(state_names)
        self.state_spec = state_spec

    def run(self, program=None, feed=None, fetch_list=None, scope=None,
            return_numpy=True, **unused):
        from ..executor import run_time_switches
        key = self.group.program_key(program)
        fetch_names = [getattr(v, 'name', v) for v in (fetch_list or [])]
        feed = {n: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                    else np.asarray(v)) for n, v in (feed or {}).items()}
        out = self.group.command('run', self.sid, key, feed, fetch_names,
                                 run_time_switches())[0]
        if return_numpy:
            return out
        return [torch.from_numpy(v) for v in out]

    def jit_cache_stats(self):
        st = self.group.command('stats', self.sid)[0]
        return {k: st[k] for k in ('prepared_programs', 'compiled_segments',
                                   'segment_hits', 'segment_misses')}

    def last_runs(self):
        """Every rank's last run: {'wall', 'records', ...} a rank."""
        return self.group.command('stats', self.sid)

    def zero(self):
        self.group.command('zero', self.sid)

    def read_rows(self, ids):
        """The whole rows `ids` of every state var, as host arrays."""
        parts = self.group.command('rows', self.sid, list(ids))
        return [assemble([p[i] for p in parts], self.state_spec, self.mesh)
                for i in range(len(self.state_names))]

    def write_rows(self, ids, data):
        """Write whole host rows at `ids` of every state var, in place:
        each rank its part."""
        split = [_split(np.asarray(d, np.float32), self.state_spec, self.mesh)
                 for d in data]
        self.group.command('write_rows', self.sid, per_rank=[
            (list(ids), [s[r] for s in split]) for r in range(self.mesh.size)])

    def layout(self):
        """Each rank's state spec and local state shapes."""
        return self.group.command('layout', self.sid)

    # the predictor's weight set
    def weights(self, names):
        """{name: whole CPU tensor} gathered from the ranks' parts."""
        parts = self.group.command('weights_out', self._ws.wid, list(names))
        out = {}
        for i, n in enumerate(names):
            ps = [p[i] for p in parts]
            spec = self._ws.specs.get(n)
            if isinstance(ps[0], torch.Tensor):
                whole = assemble([p.view(torch.int16).numpy() for p in ps],
                                 spec, self.mesh)
                out[n] = torch.from_numpy(whole).view(ps[0].dtype)
            else:
                out[n] = torch.from_numpy(assemble(ps, spec, self.mesh))
        return out

    def weight_shapes(self, names):
        """Every rank's local shape of each weight in `names`."""
        return self.group.command('weight_shapes', self._ws.wid, list(names))

    def install(self, values):
        """Bind whole values {name: tensor} on every rank, each its part
        under the weight's serve spec."""
        for name, val in values.items():
            spec = self._ws.specs.get(name)
            self.group.command('install', self._ws.wid, name, per_rank=[
                (p,) for p in _split(val, spec, self.mesh)])

    def load_sharded(self, root, names):
        """Every rank reads its own region of each weight from a sharded
        checkpoint, under the weight's serve spec."""
        specs = {n: (self._ws.specs.get(n) or ()) for n in names}
        self.group.command('load_sharded', self._ws.wid, root, specs)

    def call(self, path, *args, **kwargs):
        """Every rank's result of module:function(*args, **kwargs) (the
        tests' and the chip script's window onto the ranks)."""
        return self.group.command('call', path, args, kwargs)

    def close(self):
        self.group.release(self.sid)
