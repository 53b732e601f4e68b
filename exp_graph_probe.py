#!/usr/bin/env python3
"""The conditional (IF) graph nodes of `fcc_qp_tpu_torch.ops.device_branch`
on the card, and what the reduced path's operations cost inside one.
Run on a machine with a CUDA card, from the root of a checkout:

    python3 exp_graph_probe.py

Prints, each as one JSON line: the versions and the allocator hooks the
installed PyTorch has; whether an IF node skips and runs its body by a
0-d device flag, nested too, with the body's writes going in place into
buffers made before the node; `branch` under a capture against its
select form; the pool memory that IF bodies each allocating a temporary
take; the capture and first-replay seconds and node counts of bodies
holding the reduced path's batched operations (f32 products, Cholesky
factors and inverses under cuSOLVER, a stable argsort) at the batch
sizes the reduced path gives them; and the hand-written f32 chunk kernel
launched inside a body, equal to its launch outside one.

    python3 exp_graph_probe.py b1

captures each library factorization of one instance (and of two) into
an IF body alone and prints whether its graph instantiates.

    python3 exp_graph_probe.py alloc

captures each linear-algebra call of the parity engine's presolve
(`ops.kkt.kkt_solve`: the library's `cholesky_solve`, with one and with
m right-hand sides, against the batched triangular solves that replace
it, `ops.ds_linalg.chol_solve`; `cholesky_ex`; a product) at B = 1, 2
and 1024 into a graph of its own, under cuSOLVER, and prints its nodes
by type: memory alloc / free nodes (types 10 / 11) cannot stand in a
conditional body. Then `kkt_solve` itself, static, at B = 1 and 1024:
its graph's nodes and whether it instantiates.

    python3 exp_graph_probe.py census <root>

imports `fcc_qp_tpu_torch` from the checkout at ``<root>`` (a parent
tree, say) and captures the parity engine's cold B = 1 solve as `FCCQP`
does (`core.graphs.CapturedSolve`: a warm-up on a side stream, then the
operator and iteration graphs): their nodes by type, IF bodies
included. Where that tree's `ops.kkt` still solves with the library's
`cholesky_solve` (``_cho_solve``), the same again with only that call
replaced by two batched triangular solves, then once more as it is:
whether that call puts the memory alloc / free nodes in the graph.
"""

from __future__ import annotations

import json
import sys
import time


def out(tag, **kw):
    print(json.dumps({"probe": tag, **kw}), flush=True)


def census(top):
    """Nodes by type of a kept graph and of every IF body captured since
    the body list was last cleared (`device_branch.body_graphs`)."""
    import ctypes

    from fcc_qp_tpu_torch.ops import device_branch as db

    cu = ctypes.CDLL("libcuda.so.1")
    counts = {}
    for g in [top] + db.body_graphs:
        n = ctypes.c_size_t(0)
        assert cu.cuGraphGetNodes(ctypes.c_void_p(g), None,
                                  ctypes.byref(n)) == 0
        nodes = (ctypes.c_void_p * n.value)()
        assert cu.cuGraphGetNodes(ctypes.c_void_p(g), nodes,
                                  ctypes.byref(n)) == 0
        kind = ctypes.c_int()
        for node in nodes:
            assert cu.cuGraphNodeGetType(ctypes.c_void_p(node),
                                         ctypes.byref(kind)) == 0
            counts[kind.value] = counts.get(kind.value, 0) + 1
    return {str(k): v for k, v in sorted(counts.items())}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    census_mode = sys.argv[1:2] == ["census"]
    sys.path.insert(0, sys.argv[2] if census_mode else ".")
    from fcc_qp_tpu_torch.core.graphs import _cusolver
    from fcc_qp_tpu_torch.ops import device_branch as db

    C = torch._C
    out("versions", torch=torch.__version__, cuda=torch.version.cuda,
        device=torch.cuda.get_device_name(0),
        hooks=[n for n in dir(C) if "AllocateCurrent" in n
               or "AllocateToPool" in n])
    t0 = time.perf_counter()
    db.build_graph_nodes()
    out("build", seconds=time.perf_counter() - t0)
    dev = torch.device("cuda")
    G = torch.cuda.CUDAGraph
    if sys.argv[1:] == ["b1"]:
        return b1_ops(dev)
    if sys.argv[1:] == ["alloc"]:
        return alloc_ops(dev)
    if census_mode:
        return census_f64(dev)

    # 1. IF nodes, nested, writing in place into a buffer made before them
    flag_a = torch.zeros((), dtype=torch.bool, device=dev)
    flag_b = torch.zeros((), dtype=torch.bool, device=dev)
    acc = torch.zeros(4, device=dev)
    info = {}
    db.body_graphs.clear()
    g = G(keep_graph=True)
    with torch.cuda.graph(g):
        outer = torch.cuda.current_stream().cuda_stream
        with db.if_node(flag_a.clone()):
            info["streams_differ"] = (torch.cuda.current_stream().cuda_stream
                                      != outer)
            info["body_capturing"] = torch.cuda.is_current_stream_capturing()
            acc.add_(torch.ones(4, device=dev) * 2.0)
            with db.if_node(flag_b.clone()):
                acc.add_(10.0)
        acc.add_(0.5)
    res = {}
    for fa, fb in ((False, False), (True, False), (True, True), (False, True)):
        acc.zero_()
        flag_a.fill_(fa)
        flag_b.fill_(fb)
        g.replay()
        torch.cuda.synchronize()
        res[f"{int(fa)}{int(fb)}"] = float(acc[0])
    out("if_node", results=res,
        expected={"00": 0.5, "10": 2.5, "11": 12.5, "01": 0.5},
        nodes=census(g.raw_cuda_graph()), **info)

    # 2. branch: captured against its select form
    def step(x, y):
        z = x * 3.0 + y
        return z, (y - z)

    def run(go, x, y):
        x, y = db.branch(go, step, x, y)
        x, y = db.branch(~go, step, x, y)
        return x, y

    x0 = torch.arange(6.0, device=dev)
    y0 = torch.ones(6, device=dev)
    go = torch.zeros((), dtype=torch.bool, device=dev)
    want = {}
    for v in (False, True):
        go.fill_(v)
        want[v] = run(go, x0.clone(), y0.clone())
    xs, ys = x0.clone(), y0.clone()
    g = G()
    with torch.cuda.graph(g):
        gx, gy = run(go, xs, ys)
    got = {}
    for v in (False, True):
        xs.copy_(x0)
        ys.copy_(y0)
        go.fill_(v)
        g.replay()
        torch.cuda.synchronize()
        got[v] = (gx.clone(), gy.clone())
    out("branch", equal={str(v): all(torch.equal(a, b) for a, b in
                                     zip(got[v], want[v])) for v in got},
        returns_input_buffers=gx.data_ptr() == xs.data_ptr())
    db.forget_owned()

    # 3. pool memory of IF bodies that each allocate a temporary
    for n_bodies in (1, 8, 32):
        torch.cuda.synchronize()
        base = torch.cuda.memory_reserved()
        x = torch.zeros(64 << 20, device=dev)     # 256 MB
        pred = torch.ones((), dtype=torch.bool, device=dev)
        g = G()
        with torch.cuda.graph(g):
            for _ in range(n_bodies):
                with db.if_node(pred):
                    t = x * 2.0                     # 256 MB temporary
                    x.copy_(t * 0.5)
                    del t
        g.replay()
        torch.cuda.synchronize()
        out("pool_growth", bodies=n_bodies, temporary_mb=256,
            reserved_mb=(torch.cuda.memory_reserved() - base) / 2**20)
        del g, x

    # 4. the reduced path's batched operations inside one body
    def timed_capture(name, fn, *args):
        fn(*args)
        torch.cuda.synchronize()
        pred = torch.ones((), dtype=torch.bool, device=dev)
        db.body_graphs.clear()
        g = G(keep_graph=True)
        t0 = time.perf_counter()
        with _cusolver(), torch.cuda.graph(g):
            with db.if_node(pred):
                fn(*args)
        t_cap = time.perf_counter() - t0
        t0 = time.perf_counter()
        g.replay()
        torch.cuda.synchronize()
        t_first = time.perf_counter() - t0
        t0 = time.perf_counter()
        g.replay()
        torch.cuda.synchronize()
        out("op", name=name, capture_s=t_cap, first_replay_s=t_first,
            replay_s=time.perf_counter() - t0,
            nodes=census(g.raw_cuda_graph()))

    gen = torch.Generator(device="cpu").manual_seed(0)
    f64 = torch.float64
    for Bn in (128, 1024):
        M = torch.randn(Bn, 102, 102, generator=gen).to(dev)
        timed_capture(f"bmm_f32_B{Bn}_N102", lambda m: m @ m, M)
        H = torch.randn(Bn, 60, 60, generator=gen, dtype=f64).to(dev)
        H = H @ H.transpose(1, 2) + 60 * torch.eye(60, device=dev, dtype=f64)
        with _cusolver():
            timed_capture(f"cholesky_ex_B{Bn}_n60",
                          lambda h: torch.linalg.cholesky_ex(h), H)
            L = torch.linalg.cholesky(H)
            timed_capture(f"cholesky_inverse_B{Bn}_n60",
                          lambda l: torch.cholesky_inverse(l), L)
            E = torch.eye(60, device=dev, dtype=f64).expand(
                Bn, 60, 60).contiguous()
            timed_capture(f"solve_triangular_B{Bn}_n60",
                          lambda l, e: torch.linalg.solve_triangular(
                              l, e, upper=False), L, E)
    r = torch.rand(8192, generator=gen).to(dev) > 0.5
    timed_capture("argsort_stable_B8192",
                  lambda m: torch.argsort(-m.float(), stable=True)[:1024], r)

    # 5. the f32 chunk kernel inside a body equals its launch outside one
    from fcc_qp_tpu_torch.ops import pallas_admm
    pallas_admm.build_kernels()
    k, kb, Bn = 22, 10, 256
    g32 = torch.Generator(device="cpu").manual_seed(1)
    args = [(torch.randn(k, k, Bn, generator=g32) * 0.05).contiguous(),
            torch.randn(k, Bn, generator=g32),
            -torch.ones(kb, Bn), torch.ones(kb, Bn),
            torch.full(((k - kb) // 3, Bn), 0.7),
            torch.full((Bn,), 0.05), 1e-3, 1e-3,
            torch.zeros(k, Bn), torch.zeros(k, Bn), torch.zeros(k, Bn),
            torch.zeros(k, Bn), torch.zeros(Bn, dtype=torch.bool),
            torch.full((Bn,), 3000, dtype=torch.int32),
            torch.zeros(Bn, dtype=torch.int32), torch.zeros(Bn),
            torch.zeros(Bn), torch.zeros(Bn), torch.zeros(Bn)]
    args = [a.to(dev) if isinstance(a, torch.Tensor) else a for a in args]
    kw = dict(kb=kb, K=64, max_iter=3000,
              weights=torch.ones(k, Bn, device=dev))
    want = pallas_admm.admm_chunk_f32(*args, **kw)
    torch.cuda.synchronize()
    pred = torch.ones((), dtype=torch.bool, device=dev)
    bufs = [torch.zeros_like(w) for w in want]
    g = G()
    with torch.cuda.graph(g):
        with db.if_node(pred):
            for b_, o in zip(bufs, pallas_admm.admm_chunk_f32(*args, **kw)):
                b_.copy_(o)
    g.replay()
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(bufs, want))
    for b_ in bufs:
        b_.zero_()
    pred.fill_(False)
    g.replay()
    torch.cuda.synchronize()
    out("kernel_in_body", equal=same,
        skipped_left_buffers=all(not bool(b_.any()) for b_ in bufs))
    print(json.dumps({"ok": True}))
    return 0


def b1_ops(dev) -> int:
    """``python3 exp_graph_probe.py b1``: each library factorization on
    one instance (and on two) captured into an IF body: whether the graph
    instantiates, and the body's nodes by type (a host node, type 3, is
    not allowed in a conditional body)."""
    import torch

    from fcc_qp_tpu_torch.core.graphs import _cusolver
    from fcc_qp_tpu_torch.ops import device_branch as db

    f64 = torch.float64
    gen = torch.Generator(device="cpu").manual_seed(0)
    for Bn in (1, 2):
        H = torch.randn(Bn, 60, 60, generator=gen, dtype=f64).to(dev)
        H = H @ H.transpose(1, 2) + 60 * torch.eye(60, device=dev, dtype=f64)
        L = torch.linalg.cholesky(H)
        r1 = torch.randn(Bn, 60, 1, generator=gen, dtype=f64).to(dev)
        E = torch.eye(60, device=dev, dtype=f64)
        ops = {
            "cholesky_ex": lambda: torch.linalg.cholesky_ex(H),
            "cholesky_solve_nrhs1": lambda: torch.cholesky_solve(r1, L),
            "cholesky_solve_nrhs60": lambda: torch.cholesky_solve(
                E.expand(Bn, 60, 60), L),
            "solve_triangular": lambda: torch.linalg.solve_triangular(
                L, E, upper=False),
            "matmul": lambda: H @ H,
        }
        for name, fn in ops.items():
            with _cusolver():
                fn()
                torch.cuda.synchronize()
                pred = torch.ones((), dtype=torch.bool, device=dev)
                db.body_graphs.clear()
                g = torch.cuda.CUDAGraph(keep_graph=True)
                try:
                    with torch.cuda.graph(g):
                        with db.if_node(pred):
                            fn()
                    nodes = census(g.raw_cuda_graph())
                    g.instantiate()
                    g.replay()
                    torch.cuda.synchronize()
                    out("b1_op", B=Bn, name=name, ok=True, nodes=nodes)
                except Exception as e:  # report every op, then go on
                    out("b1_op", B=Bn, name=name, ok=False,
                        error=str(e).splitlines()[0])
                    torch.cuda.synchronize()
    print(json.dumps({"ok": True}))
    return 0


def alloc_ops(dev) -> int:
    """``python3 exp_graph_probe.py alloc`` (the module docstring)."""
    import torch

    from fcc_qp_tpu_torch.core.graphs import _cusolver
    from fcc_qp_tpu_torch.ops import device_branch as db
    from fcc_qp_tpu_torch.ops import kkt
    from fcc_qp_tpu_torch.ops.ds_linalg import chol_solve

    f64 = torch.float64
    n, m = 60, 38
    gen = torch.Generator(device="cpu").manual_seed(0)

    def captured(name, Bn, fn):
        with _cusolver():
            fn()
            torch.cuda.synchronize()
            db.body_graphs.clear()
            g = torch.cuda.CUDAGraph(keep_graph=True)
            try:
                with torch.cuda.graph(g):
                    fn()
                db.forget_owned()
                nodes = census(g.raw_cuda_graph())
                g.instantiate()
                g.replay()
                torch.cuda.synchronize()
                out("alloc_op", B=Bn, name=name, ok=True, nodes=nodes,
                    mem_alloc=nodes.get("10", 0), mem_free=nodes.get("11", 0))
            except Exception as e:  # report every op, then go on
                out("alloc_op", B=Bn, name=name, ok=False,
                    error=str(e).splitlines()[0])
                torch.cuda.synchronize()

    for Bn in (1, 2, 1024):
        H = torch.randn(Bn, n, n, generator=gen, dtype=f64).to(dev)
        H = H @ H.transpose(1, 2) + n * torch.eye(n, device=dev, dtype=f64)
        A = torch.randn(Bn, m, n, generator=gen, dtype=f64).to(dev)
        L = torch.linalg.cholesky(H)
        r1 = torch.randn(Bn, n, 1, generator=gen, dtype=f64).to(dev)
        At = A.transpose(1, 2)
        ops = {
            "cholesky_ex": lambda: torch.linalg.cholesky_ex(H),
            "cholesky_solve_nrhs1": lambda: torch.cholesky_solve(r1, L),
            "cholesky_solve_nrhs_m": lambda: torch.cholesky_solve(At, L),
            "chol_solve_nrhs1": lambda: chol_solve(L, r1),
            "chol_solve_nrhs_m": lambda: chol_solve(L, At),
            "matmul": lambda: H @ H,
            "kkt_solve_static": lambda: kkt.kkt_solve(
                H, A, 0.0, r1[..., 0], torch.zeros(Bn, m, dtype=f64,
                                                   device=dev),
                static=True),
        }
        for name, fn in ops.items():
            captured(name, Bn, fn)
    print(json.dumps({"ok": True}))
    return 0


def census_f64(dev) -> int:
    """``python3 exp_graph_probe.py census <root>`` (the module
    docstring)."""
    import ctypes

    import torch

    import fcc_qp_tpu_torch
    from fcc_qp_tpu_torch import FCCQPOptions
    from fcc_qp_tpu_torch.core.graphs import (CapturedSolve, SolveBuffers,
                                              layout, pack_host)
    from fcc_qp_tpu_torch.models.osc import CASSIE, generate_osc_sequence
    from fcc_qp_tpu_torch.ops import device_branch as db
    from fcc_qp_tpu_torch.ops import kkt

    out("tree", package=fcc_qp_tpu_torch.__file__,
        has_cho_solve=hasattr(kkt, "_cho_solve"))
    shape = CASSIE.shape
    keys = ("Q", "b", "A_eq", "b_eq", "friction_coeffs", "lb", "ub")
    qp = generate_osc_sequence(CASSIE, 1, seed=1)[0]
    host = torch.empty((layout(shape)[-1],), dtype=torch.float64)
    pack_host(shape, [qp[k] for k in keys], host)
    opts = FCCQPOptions(max_iter=2000, rho=1.0, eps_fcone=1e-6,
                        eps_bound=1e-6)
    cu = ctypes.CDLL("libcuda.so.1")

    def nodes_of(handles):
        counts = {}
        for h in handles:
            n = ctypes.c_size_t(0)
            assert cu.cuGraphGetNodes(ctypes.c_void_p(h), None,
                                      ctypes.byref(n)) == 0
            arr = (ctypes.c_void_p * n.value)()
            assert cu.cuGraphGetNodes(ctypes.c_void_p(h), arr,
                                      ctypes.byref(n)) == 0
            kind = ctypes.c_int()
            for node in arr:
                assert cu.cuGraphNodeGetType(ctypes.c_void_p(node),
                                             ctypes.byref(kind)) == 0
                counts[kind.value] = counts.get(kind.value, 0) + 1
        return {str(k): v for k, v in sorted(counts.items())}

    def capture(label):
        graph_cls = torch.cuda.CUDAGraph
        db.body_graphs.clear()
        solve = CapturedSolve(shape, opts, "f64",
                              SolveBuffers(shape, "f64", "cuda", opts.rho))
        torch.cuda.CUDAGraph = lambda: graph_cls(keep_graph=True)
        try:
            solve.buffers.inp.copy_(host)
            solve.run(warm_start=False)
            torch.cuda.synchronize()
            cold = solve._captured[False][:2]
            nodes = nodes_of([g.raw_cuda_graph() for g in cold]
                             + list(db.body_graphs))
            out("census", variant=label, ok=True, nodes=nodes,
                mem_alloc=nodes.get("10", 0), mem_free=nodes.get("11", 0),
                z=float(solve.buffers.out[0]))
        except Exception as e:  # report the variant, then go on
            out("census", variant=label, ok=False,
                error=str(e).splitlines()[0])
            torch.cuda.synchronize()
        finally:
            torch.cuda.CUDAGraph = graph_cls

    capture("as_is")
    if hasattr(kkt, "_cho_solve"):
        library = kkt._cho_solve

        def triangular(L, R):
            Y = torch.linalg.solve_triangular(L, R, upper=False)
            return torch.linalg.solve_triangular(L.transpose(-1, -2), Y,
                                                 upper=True)

        kkt._cho_solve = triangular
        capture("cho_solve_triangular")
        kkt._cho_solve = library
        capture("as_is_again")
    print(json.dumps({"ok": True}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
