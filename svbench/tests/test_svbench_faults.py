"""A run with the timed path broken underneath comes out as not correct.

Each case drives the rest of a run (`harness.measure`, past the look for a
card, on the CPU at a size a test run holds) with one fault planted in the
program, and sees `correct` come out false.  The sound run beside them, at
the same size and seed, holds under the limit that each fault pushes over.
Two jobs of a test's size hold no SV at the configuration's density, so
the test's copy of the configuration implants them 20 times as densely;
the limits are the cell's own.  The faults a cell on one chip can have:

- state: a step returns its state unchanged (the polish hands back its
  drafts);
- half: half of the batch left out (every other job of the window does
  nothing and leaves no outputs);
- altered: an answer altered where it is produced (each small-indel call
  of `run`, and each large-indel call of the vc drivers, moved 1 kb along
  the chromosome);
- doubled: each large-indel call reported twice (the false calls that
  `sv_err` counts).

The exchange between chips does not exist on one chip.
"""
import contextlib

import pytest

from svbench import harness

CASES = {"hifi-run-250kb": 40_000, "hifi-vc-otherasm-1mb": 60_000}
FAULTS = {"hifi-run-250kb": ["none", "state", "half", "altered"],
          "hifi-vc-otherasm-1mb": ["none", "half", "altered", "doubled"]}
DENSER = 20


@contextlib.contextmanager
def planted(fault: str, run_cell: bool):
    import volcanosv_tpu_torch.assembly.farm as farm
    import volcanosv_tpu_torch.cli as cli
    undo = []

    def patch(owner, attr, new):
        undo.append((owner, attr, getattr(owner, attr)))
        setattr(owner, attr, new)
    if fault == "state":
        patch(farm, "polish_grouped", lambda drafts, *a, **kw: (drafts, {}))
    elif fault == "half":
        main, calls = cli.main, [0]

        def every_other_job(argv):
            calls[0] += argv[0] in ("run", "vc-large-indel")
            if calls[0] % 2 == 0:
                return 0
            return main(argv)
        patch(cli, "main", every_other_job)
    elif fault == "altered":
        import volcanosv_tpu_torch.vc.small_indel as small_indel
        owner, attr = (small_indel, "call_small_indels") if run_cell \
            else (cli, "_call_large_indels")
        call = getattr(owner, attr)

        def moved(*a, **kw):
            recs = call(*a, **kw)
            for r in recs:
                r.pos += 1000
                if "END" in r.info:
                    r.info["END"] = int(r.info["END"]) + 1000
            return recs
        patch(owner, attr, moved)
    elif fault == "doubled":
        import copy
        call = cli._call_large_indels

        def doubled(*a, **kw):
            recs = call(*a, **kw)
            twins = []
            for r in recs:
                t = copy.deepcopy(r)
                t.id = f"{r.id}_twin"
                twins.append(t)
            return recs + twins
        patch(cli, "_call_large_indels", doubled)
    try:
        yield
    finally:
        for owner, attr, old in reversed(undo):
            setattr(owner, attr, old)


# what each fault must push over its limit, where the sound run stays under
TARGET = {"hifi-run-250kb": {"state": "contig_err", "altered": "small_err"},
          "hifi-vc-otherasm-1mb": {"altered": "sv_err", "doubled": "sv_err"}}
_sound: dict = {}


def run(cell: str, fault: str) -> dict:
    spec = harness.load_cell(cell)
    var = spec["config"]["variants"]
    var["sv_per_mb"] = {k: v * DENSER for k, v in var["sv_per_mb"].items()}
    t = spec["traffic"]
    spec["traffic"] = dict(t, job_length=CASES[cell], pool=2)
    if "contigs" in t:
        spec["traffic"]["contigs"] = {"block_size": 20_000, "overlap": 3_000}
    with planted(fault, run_cell="contigs" in t["answers"]):
        return harness.measure(spec, seed=9_000_000_011, seconds=1e9,
                               trace=False, device="cpu")


def sound(cell: str) -> dict:
    if cell not in _sound:
        _sound[cell] = run(cell, "none")
    return _sound[cell]


@pytest.mark.parametrize("cell,fault", [(c, f) for c in CASES
                                        for f in FAULTS[c]])
def test_a_fault_makes_the_run_incorrect(cell, fault):
    ok = sound(cell)
    assert ok["attempted"] == 2 and ok["failed"] == 0
    if fault == "none":
        return
    r = run(cell, fault)
    assert r["attempted"] == 2
    assert r["correct"] is False, r["checks"]
    if fault == "half":
        assert r["failed"] == 1
    else:
        name = TARGET[cell][fault]
        assert ok["checks"][name]["value"] <= ok["checks"][name]["limit"]
        assert r["checks"][name]["value"] > r["checks"][name]["limit"], \
            r["checks"]
