"""The port's analysis layer analysed, and the two API faults it needed
repaired.

  * the faults: ``mesh_axis=`` taken by every stream entry point the
    reference gives it, and ``DecoderRegistry`` membership, iteration and
    ``items()`` as the reference's;
  * repo-rule linter — RPR001, RPR003 (the reference's idioms) and RPR005
    held against the reference's own linter on the same hand-made snippets
    (same codes, same lines); RPR002, RPR003's torch idioms and RPR004,
    whose meaning changed, against hand-made violations; pragma parsing;
    the port's tree lints clean and every pragma suppresses a real hit;
  * op-trace lint — a clean function passes; an injected float64 constant,
    bf16 outside the metric dtype, a ``.item()`` inside the path, a
    collective, an output over budget and a CPU op inside a device path
    each produce the right ``ContractViolation`` kind, with its source line
    (the ``meta`` device stands in for the card on the CPU);
  * runtime guards — ``sanitized()`` counts the CPU's host routes, raises on
    NaN, counts rebuilds, guards transfers, refuses to nest and restores
    everything it patched;
  * the hot-path catalog covers exactly the registry and runs clean on the
    CPU, and the CLI exits 0 on the tree and 1 on a violation of each rule.

The reference's own ``repro.analysis`` jaxpr checks fail on this tree
(``from jax.core import Jaxpr``); its AST linter imports no JAX at module
level and runs here.
"""
import textwrap
from pathlib import Path

import jax  # noqa: F401  (both frameworks in one process; JAX stays on the CPU)
import numpy as np
import pytest
import torch

import repro.analysis.repo_lint as R_lint
import repro.decode as RD
from repro_torch.analysis import (
    CARD_TEST_EXEMPT,
    Contract,
    TransferError,
    check_hot_paths,
    count_pragmas,
    find_pragmas,
    hot_path_catalog,
    lint_paths,
    problems,
    sanitized,
    trace_contract,
)
from repro_torch.analysis import repo_lint as P_lint
from repro_torch.core import CODE_K3_STD
from repro_torch.decode import REGISTRY, list_decoders

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "src" / "repro_torch"


# --------------------------------------------------------------------------- #
# the two API faults                                                           #
# --------------------------------------------------------------------------- #


def test_stream_entry_points_take_mesh_axis():
    from repro_torch.stream import StreamScheduler, StreamSession
    from repro_torch.stream.resilience import restore_scheduler

    sched = StreamScheduler(CODE_K3_STD, n_slots=2, chunk=8, device="cpu", mesh_axis="data")
    sched.open_stream("a")
    sched.submit_chunk("a", np.zeros((20, 4), np.float32))
    sched.step()
    snap = sched.snapshot()
    for restored in (restore_scheduler(snap, mesh_axis="data", device="cpu"),
                     StreamScheduler.restore(snap, mesh_axis="data", device="cpu")):
        assert restored.n_slots == 2 and "a" in restored._by_id
    StreamSession(CODE_K3_STD, batch=2, chunk=8, device="cpu", mesh_axis="data")
    # a mesh runs, sharded along mesh_axis (tests/test_torch_sharded_stream.py);
    # anything but a repro_torch Mesh is refused by type
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh((2, 1), ("data", "model"), devices=["cpu"] * 2)
    for restored in (restore_scheduler(snap, mesh=mesh, mesh_axis="data", device="cpu"),
                     StreamScheduler.restore(snap, mesh=mesh, mesh_axis="data", device="cpu")):
        assert restored.n_shards == 2 and "a" in restored._by_id
    assert StreamSession(CODE_K3_STD, batch=2, chunk=8, device="cpu", mesh=mesh,
                         mesh_axis="data").mesh is mesh
    for make in (lambda: StreamScheduler(CODE_K3_STD, device="cpu", mesh=object(),
                                         mesh_axis="data"),
                 lambda: StreamSession(CODE_K3_STD, device="cpu", mesh=object()),
                 lambda: restore_scheduler(snap, mesh=object(), device="cpu")):
        with pytest.raises(TypeError, match="Mesh"):
            make()


def test_registry_iterates_and_contains_like_reference():
    assert "fused" in REGISTRY and "fused" in RD.REGISTRY
    assert "no-such-backend" not in REGISTRY
    assert [d.name for d in REGISTRY] == [d.name for d in RD.REGISTRY]
    assert len(list(REGISTRY)) == 10
    items = dict(REGISTRY.items())
    assert list(items) == [name for name, _ in RD.REGISTRY.items()]
    for name, dec in items.items():
        assert dec is REGISTRY.get(name) and dec.name == name


# --------------------------------------------------------------------------- #
# repo-rule linter                                                             #
# --------------------------------------------------------------------------- #


def _lint(linter, tmp_path, rel, code):
    path = tmp_path / rel
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(textwrap.dedent(code))
    violations, n = linter.lint_paths([path], repo_rules=False)
    assert n == 1
    return [(v.rule, v.line) for v in violations]


SHARED_SNIPPETS = {
    # rule: (reference path, port path, code) — the same meaning in both
    "RPR001": ("src/repro/x.py", "src/repro_torch/x.py", """
        from repro.obs.log import get_logger
        def f():
            print("debug")
            get_logger("x").info("debug")
    """),
    "RPR003": ("repro/kernels/hot.py", "repro_torch/kernels/hot.py", """
        import numpy as np
        import jax
        def f(x, n):
            a = np.array(x)
            b = float(x[0])
            c = x.item()
            d = x.block_until_ready()
            e = jax.device_get(x)
            g = np.asarray(x)  # repr-lint: allow[RPR003]
            return a, b, c, d, e, g, int(n)
    """),
    "RPR003-scope": ("repro/stream/scheduler.py", "repro_torch/stream/scheduler.py", """
        import numpy as np
        def load_report(x):
            return np.asarray(x)
        def _step_traced(x):
            return np.asarray(x)
    """),
    "RPR005": ("src/repro/b.py", "src/repro_torch/b.py", """
        @register_decoder("x", capabilities=BackendCapabilities(online=True))
        def d(spec, bm, *, ctx):
            return None
        @register_decoder("y")
        def e(spec, bm, *, ctx):
            return None
        @register_decoder("z", capabilities=BackendCapabilities(family="conv"))
        def g(spec, bm, *, ctx):
            return None
    """),
}


@pytest.mark.parametrize("rule", sorted(SHARED_SNIPPETS))
def test_shared_rules_agree_with_reference_linter(tmp_path, rule):
    ref_path, port_path, code = SHARED_SNIPPETS[rule]
    want = _lint(R_lint, tmp_path / "ref", ref_path, code)
    got = _lint(P_lint, tmp_path / "port", port_path, code)
    assert got == want and got, (got, want)


def test_rpr002_raw_device_literal_at_a_call_site(tmp_path):
    bad = _lint(P_lint, tmp_path, "src/repro_torch/k.py", """
        import torch
        def f(x):
            a = torch.zeros(3, device="cuda")
            return run(x, device="cpu"), torch.ones(2, device="cuda:0")
    """)
    assert bad == [("RPR002", 4), ("RPR002", 5), ("RPR002", 5)]
    # a default in a signature, a forwarded or resolved device: all fine
    good = _lint(P_lint, tmp_path, "src/repro_torch/k2.py", """
        import torch
        def f(x, device="cuda"):
            dev = resolve_device(device)
            return torch.zeros(3, device=dev), run(x, device=device)
    """)
    assert good == []
    # outside the library (tests, scripts) the rule does not apply
    assert _lint(P_lint, tmp_path, "tests/test_k.py", """
        run(1, device="cpu")
    """) == []


def test_rpr003_torch_idioms_in_hot_scopes(tmp_path):
    bad = _lint(P_lint, tmp_path, "repro_torch/stream/window.py", """
        import torch
        def tick(x, n):
            a = x.tolist()
            b = x.cpu()
            c = b.numpy()
            torch.cuda.synchronize()
            d = int(torch.sum(x))
            e = bool(x.any())
            f = int(x.max() > 0)
            return a, c, d, e, f, int(n), bool(n)
    """)
    assert bad == [("RPR003", line) for line in range(4, 11)]
    # outside the hot scopes the same idioms are host bookkeeping
    assert _lint(P_lint, tmp_path, "repro_torch/stream/ingest.py", """
        def report(x):
            return x.cpu().numpy().tolist()
    """) == []


def test_rpr004_uncovered_backend_rejected(tmp_path):
    (tmp_path / "pyproject.toml").write_text("[project]\nname='fx'\n")
    src = tmp_path / "src" / "repro_torch"
    src.mkdir(parents=True)
    (src / "mod.py").write_text(textwrap.dedent("""
        @register_decoder("ghost", capabilities=BackendCapabilities(family="conv"))
        def d(spec, bm, *, ctx):
            return None
    """))
    tests = tmp_path / "tests"
    tests.mkdir()
    (tests / "test_torch_decode.py").write_text("EXPECTED_BACKENDS = ()\n")
    (tests / "test_torch_gpu.py").write_text("CARD_BACKENDS = ()\n")
    violations = P_lint.check_backend_coverage(tmp_path)
    assert [v.rule for v in violations] == ["RPR004", "RPR004"]
    msgs = " ".join(v.message for v in violations)
    assert "parity grid" in msgs and "card test" in msgs
    (tests / "test_torch_decode.py").write_text("EXPECTED_BACKENDS = ('ghost',)\n")
    (tests / "test_torch_gpu.py").write_text("CARD_BACKENDS = ('ghost',)\n")
    assert P_lint.check_backend_coverage(tmp_path) == []


def test_rpr004_exemptions_name_real_backends_with_reasons():
    for name, reason in CARD_TEST_EXEMPT.items():
        assert name in list_decoders()
        assert "9b" in reason and len(reason) > 40


def test_pragma_parser_handles_multiple_codes():
    source = "x = 1  # repr-lint: allow[RPR001, RPR003]\ny = 2\n"
    assert find_pragmas(source) == {1: {"RPR001", "RPR003"}}
    assert find_pragmas(source) == R_lint.find_pragmas(source)


def test_port_lints_clean():
    violations, n_files = lint_paths([PORT])
    assert violations == [], "\n".join(map(str, violations))
    assert n_files > 50


def test_the_one_sanctioned_sync_is_the_only_stream_rpr003_pragma():
    assert count_pragmas([PORT / "stream"]) == {"RPR003": 1}
    sched = (PORT / "stream" / "scheduler.py").read_text()
    line = next(text for text in sched.splitlines() if "repr-lint: allow" in text)
    assert "bits.cpu().numpy()" in line


def test_every_pragma_suppresses_a_real_hit(tmp_path):
    """Strip the pragmas from a copy of the port and lint it: each pragma
    line is flagged for the rule it allows, and nothing else is."""
    pragma_lines = set()
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(PORT.parent)
        text = path.read_text()
        for line, codes in find_pragmas(text).items():
            pragma_lines |= {(f"{rel.as_posix()}", line, code) for code in codes}
        out = tmp_path / rel
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(P_lint._PRAGMA_RE.sub("", text))
    violations, _ = lint_paths([tmp_path / "repro_torch"], repo_rules=False)
    flagged = {(str(Path(v.path).resolve().relative_to(tmp_path.resolve()).as_posix()),
                v.line, v.rule) for v in violations}
    assert flagged == pragma_lines and len(pragma_lines) >= 8


def test_cli_clean_on_the_port_and_failing_on_each_rule(tmp_path):
    from repro_torch.analysis.__main__ import main

    assert main([str(PORT), "--quiet"]) == 0
    loose = tmp_path / "bad.py"
    loose.write_text("print('hi')\n")
    # a loose file outside src/repro_torch is not library code: RPR001 no-op
    assert main([str(loose), "--quiet"]) == 0
    bad = {
        "RPR001": ("p.py", "print('hi')\n"),
        "RPR002": ("d.py", "run(1, device='cuda')\n"),
        "RPR003": ("kernels/s.py", "def f(x):\n    return x.item()\n"),
        "RPR005": ("r.py", "@register_decoder('x')\ndef d(spec, bm, *, ctx):\n    pass\n"),
    }
    for rule, (name, code) in bad.items():
        path = tmp_path / rule / "src" / "repro_torch" / name
        path.parent.mkdir(parents=True)
        path.write_text(code)
        assert main([str(path.parent), "--quiet"]) == 1, rule
        violations, _ = lint_paths([path.parent], repo_rules=False)
        assert [v.rule for v in violations] == [rule]
    # RPR004 is cross-file: a repo whose registry names a backend no test covers
    repo = tmp_path / "repo"
    (repo / "src" / "repro_torch").mkdir(parents=True)
    (repo / "tests").mkdir()
    (repo / "pyproject.toml").write_text("[project]\nname='fx'\n")
    (repo / "src" / "repro_torch" / "m.py").write_text(
        "@register_decoder('ghost', capabilities=BackendCapabilities(family='conv'))\n"
        "def d(spec, bm, *, ctx):\n    pass\n")
    (repo / "tests" / "test_torch_decode.py").write_text("EXPECTED_BACKENDS = ()\n")
    (repo / "tests" / "test_torch_gpu.py").write_text("CARD_BACKENDS = ()\n")
    assert main([str(repo / "src" / "repro_torch"), "--quiet"]) == 1
    assert main([str(repo / "src" / "repro_torch"), "--quiet", "--no-repo-rules"]) == 0
    assert main([str(tmp_path / "missing.py"), "--quiet"]) == 2


# --------------------------------------------------------------------------- #
# op-trace contract lint                                                       #
# --------------------------------------------------------------------------- #


def _kinds(violations):
    return sorted({v.kind for v in violations})


def test_clean_function_has_no_violations():
    trace, violations = trace_contract(
        lambda x: (torch.cumsum(x * 2.0, 0), torch.min(x)), [torch.ones(8)],
        Contract(name="clean", max_outputs=2))
    assert violations == [] and len(trace) > 0 and trace.device == "cpu"


def test_injected_float64_constant_is_flagged_with_source_line():
    def f(x):
        y = x.to(torch.float64) * 1.5  # the leak
        return y.to(torch.float32)

    _, violations = trace_contract(f, [torch.ones(4)], Contract(name="f32-only"))
    assert _kinds(violations) == ["float64"]
    assert any("test_torch_analysis" in v.where for v in violations)


def test_bf16_outside_metric_dtype_is_a_dtype_violation():
    def f(x):
        return x + x.to(torch.bfloat16).to(torch.float32)

    _, violations = trace_contract(f, [torch.ones(4)], Contract(name="strict"))
    assert _kinds(violations) == ["dtype"]
    _, tolerated = trace_contract(f, [torch.ones(4)],
                                  Contract(name="mixed", extra_float_dtypes=("bfloat16",)))
    assert tolerated == []


def test_item_inside_the_path_is_a_host_sync_unless_at_a_sync_site():
    def f(x):
        return x * x.sum().item()

    _, violations = trace_contract(f, [torch.ones(4)], Contract(name="no-sync"))
    assert _kinds(violations) == ["host-sync"]
    (v,) = violations
    assert v.op == "_local_scalar_dense" and "test_torch_analysis.py:" in v.where
    site = v.where.split(" ", 1)[0]
    _, sanctioned = trace_contract(f, [torch.ones(4)],
                                   Contract(name="one-sync", max_host_syncs=1,
                                            sync_sites=(site,)))
    assert sanctioned == []


def test_output_budget_is_enforced():
    _, violations = trace_contract(lambda x: (x, x * 2, x * 3), [torch.ones(4)],
                                   Contract(name="two-out", max_outputs=2))
    assert _kinds(violations) == ["outputs"]


def test_cpu_op_inside_a_device_path_is_a_device_violation():
    def f(x):
        host = torch.arange(4.0) * 2  # computed on the host mid-path
        up = host.to(x.device)  # an explicit upload: legal, counted
        return x + up

    trace, violations = trace_contract(f, [torch.ones(4, device="meta")], Contract(name="dev"))
    assert _kinds(violations) == ["device"]
    assert all("test_torch_analysis" in v.where for v in violations)
    assert trace.uploads == 1
    # an implicit transfer (a host index tensor in a device op) as well; a
    # 0-dim host tensor is a scalar passed by value, as in ``x[i] = 0.0``
    _, violations = trace_contract(lambda x: x[torch.tensor([0, 1])],
                                   [torch.ones(4, device="meta")], Contract(name="dev"))
    assert [v.op for v in violations] == ["index"]
    _, violations = trace_contract(lambda x: x * torch.tensor(2.0),
                                   [torch.ones(4, device="meta")], Contract(name="dev"))
    assert violations == []


def test_collective_outside_the_allowlist(tmp_path):
    import torch.distributed as dist

    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    try:
        def f(x):
            dist.all_reduce(x)
            return x

        _, violations = trace_contract(f, [torch.ones(4)], Contract(name="comms-free"))
        assert _kinds(violations) == ["collective"]
        _, allowed = trace_contract(f, [torch.ones(4)], Contract(
            name="seam", allowed_collectives=frozenset({violations[0].op})))
        assert allowed == []
    finally:
        dist.destroy_process_group()


def test_mesh_collective_outside_the_allowlist_is_flagged():
    """A catalog entry's check counts the calls into parallel/collectives.py
    during the traced call: a path that gathers over its mesh breaks a
    comms-free contract, and passes once the contract allowlists the
    gather."""
    from repro_torch.analysis.hotpaths import HotPath, _check_one, _contract
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel import collectives

    mesh = make_mesh((2,), ("data",), devices=["cpu"] * 2)

    def build(device):
        return (lambda x: collectives.gather(mesh, "data", [x, x + 1])), (torch.ones(3),)

    for allowed, kinds in ((frozenset(), ["collective"]), (frozenset({"gather"}), [])):
        path = HotPath(name="gathers", backend="sequential",
                       contract=_contract("gathers", allowed_collectives=allowed), build=build)
        entry = _check_one(path, torch.device("cpu"))
        assert [v.kind for v in entry["violations"]] == kinds
        assert entry["collectives"] == {"gather": 1}


# --------------------------------------------------------------------------- #
# runtime guards                                                               #
# --------------------------------------------------------------------------- #


def test_sanitized_counts_host_routes_on_the_cpu():
    x = torch.arange(8.0)
    with sanitized(transfer_guard=None, debug_nans=False, device="cpu") as rep:
        np.asarray(x)
        float(x[0])
        x.numpy()
        x.tolist()
        x[1].item()
        bool(x[2] > 1)
        int(x[3])
        assert rep.host_syncs == 7
        np.asarray(np.ones(3))  # host -> host: not a sync
        assert rep.host_syncs == 7
        assert all(site.startswith("test_torch_analysis.py:") for site in rep.sync_sites)
    assert rep.host_syncs == 7


def test_sanitized_raises_at_the_first_nan_and_not_on_empty_outputs():
    with sanitized(transfer_guard=None, count_host_syncs=False, device="cpu") as rep:
        torch.empty((1 << 12,))  # uninitialised memory is not a NaN source
        with pytest.raises(FloatingPointError, match="log"):
            torch.log(torch.tensor(-1.0))
        assert rep.host_syncs == 0  # the check's own reads are not counted


def test_sanitized_transfer_guard_blocks_implicit_and_allows_window():
    with sanitized(debug_nans=False, count_host_syncs=False, device="cpu") as rep:
        x = torch.ones(3, device="meta")
        with pytest.raises(TransferError, match="[Dd]isallow"):
            x[torch.tensor([0, 1])]  # a host index in a device op
        with rep.allow_transfers():
            x[torch.tensor([0, 1])]
        x * torch.tensor(2.0)  # a host scalar: passed by value
        torch.ones(3).to("meta")  # explicit: legal, counted
        assert rep.uploads == 1


def test_sanitized_counts_rebuilds_and_freezes_on_exit():
    from repro_torch.kernels import viterbi_scan

    def fresh():
        return tuple(torch.rand(shape) for shape in ((4, 2), (4, 2), (4, 2)))

    weights = fresh()
    with sanitized(transfer_guard=None, debug_nans=False, device="cpu") as rep:
        viterbi_scan.row_operands(*weights)
        assert rep.rebuilds == 1
        viterbi_scan.row_operands(*weights)  # cached: no rebuild
        assert rep.rebuilds == 1
    viterbi_scan.row_operands(*fresh())
    assert rep.rebuilds == 1  # frozen after exit


def test_sanitized_does_not_nest_and_restores_what_it_patched():
    saved = {name: torch.Tensor.__dict__.get(name) for name in
             ("item", "tolist", "numpy", "__float__", "__int__", "__bool__")}
    orig_asarray, orig_array = np.asarray, np.array
    with pytest.raises(RuntimeError, match="nest"):
        with sanitized(device="cpu"):
            with sanitized(device="cpu"):
                pass
    assert np.asarray is orig_asarray and np.array is orig_array
    assert {name: torch.Tensor.__dict__.get(name) for name in saved} == saved
    with sanitized(device="cpu"):  # the failed nesting released the guard
        pass


def test_sanitized_on_the_card_needs_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        with sanitized():
            pass


# --------------------------------------------------------------------------- #
# the hot-path catalog                                                         #
# --------------------------------------------------------------------------- #


def test_every_registered_backend_is_checked_and_clean_on_the_cpu():
    report = check_hot_paths(device="cpu")
    assert {entry["backend"] for entry in report.values()} == set(list_decoders())
    assert len(report) == len(list_decoders())
    for name, entry in report.items():
        assert problems(entry, "cpu") == [], name
        assert entry["host_syncs"] <= entry["max_host_syncs"], name
    assert report["stream_tick"]["host_syncs"] == 1  # the committed bits
    # the sharded tick runs the packed tick's kernels (plain here), with no
    # host sync and no collective: no transfer between shards
    sharded = report["sharded_stream_tick"]
    assert sharded["violations"] == [] and sharded["collectives"] == {}
    assert sharded["host_syncs"] == sharded["max_host_syncs"] == 0
    assert sharded["plain"] == {"viterbi_scan_packed_carry": 1, "traceback_packed": 1}
    for name in ("sequential", "fused", "fused_packed", "tiled", "parallel", "seqparallel",
                 "bcjr", "turbo_iteration", "stream_tick", "sharded_stream_tick"):
        assert report[name]["ops"] > 0, name
    # seqparallel runs for real: the plain versions of the kernels its
    # contract names, no host sync (its bound), no violation
    seq = report["seqparallel"]
    assert set(seq["plain"]) == {"viterbi_scan_packed_window", "minplus_matmul",
                                 "viterbi_scan_packed_carry", "traceback_packed"}
    assert seq["violations"] == [] and seq["host_syncs"] == seq["max_host_syncs"] == 0


def test_catalog_contracts_are_strict_and_their_sync_lines_current():
    from repro_torch.kernels import launch_counts  # noqa: F401  (the counter names)
    from repro_torch.kernels import bcjr, minplus, survivors, texpand, viterbi_scan

    kernel_names = {viterbi_scan.NAME, viterbi_scan.CARRY_NAME, viterbi_scan.WINDOW_NAME,
                    viterbi_scan.UNPACKED_CARRY_NAME, viterbi_scan.UNPACKED_NAME,
                    survivors.NAME, survivors.WINDOW_NAME, texpand.NAME, bcjr.ALPHA_NAME,
                    bcjr.BETA_NAME, minplus.NAME}
    for hp in hot_path_catalog():
        c = hp.contract
        # seqparallel gathers its shards' transfer matrices (the reference
        # allowlists its all_gather too); every other path is comms-free
        want = frozenset({"all_gather"}) if hp.name == "seqparallel" else frozenset()
        assert c.allowed_collectives == want, hp.name
        assert set(c.kernels) <= kernel_names, hp.name
        assert len(c.sync_sites) <= c.max_host_syncs
        for site in c.sync_sites:
            rel, line = site.rsplit(":", 1)
            text = (PORT.parent / rel).read_text().splitlines()[int(line) - 1]
            assert ".to(" in text or ".cpu()" in text, (hp.name, site, text)
