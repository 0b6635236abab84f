#!/usr/bin/env python3
"""The source paper's instruction and cycle-count model (Tables III-V, the
cycle rows of Fig. 3 and the processor rows of Fig. 4), on the port.

    python3 tools/paper_model.py

Prints one JSON object: ``table3`` (DLX on CPUSim), ``table4`` (PicoJava II
on MIC-1), ``table5`` (NIOS II f/s/e), ``fig3_cycle_model`` (coded bits 12
to 60), ``fig4_improvement_pct`` (the five processors) and ``matches_paper``
(each table against the published numbers).  Exits 1 if a table disagrees
with the paper.

The model (the paper's §V):
  microcoded (DLX, PicoJava):  total micro-instructions = (M.I + A.I) * calls,
                               total cycles = micro-instructions * 4
  NIOS II:                     total cycles = cycles a call * calls
  calls(coded bits):           one trellis-expansion call per active state a
                               step (1, 2, 4, 4, ... for the 4-state K=3
                               code): 19 for 12 coded bits, 2 * bits - 5.

The calls come from ``repro_torch.core.trellis.paper_expansion_calls``; the
constants below are the paper's.  Pure Python: no device.
"""
from __future__ import annotations

import dataclasses
import json
import math
import sys
from pathlib import Path
from typing import Dict, List

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch.core.trellis import CODE_K3_STD, ConvCode, paper_expansion_calls  # noqa: E402


@dataclasses.dataclass(frozen=True)
class MicrocodedImpl:
    """A DLX/PicoJava-style implementation (micro-instruction counting)."""

    name: str
    assembly_instructions: int  # A.I
    microinstructions: int  # M.I a call
    cycles_per_microinstruction: int = 4

    def total_mi(self, calls: int) -> int:
        return (self.microinstructions + self.assembly_instructions) * calls

    def total_cycles(self, calls: int) -> int:
        return self.total_mi(calls) * self.cycles_per_microinstruction


@dataclasses.dataclass(frozen=True)
class NiosImpl:
    """A NIOS II-style implementation (direct cycle counting)."""

    name: str
    cycles_per_call: int

    def total_cycles(self, calls: int) -> int:
        return self.cycles_per_call * calls


# ----------------------------- the paper's constants ----------------------------- #

DLX_ASSEMBLY = MicrocodedImpl("DLX trellis assembly fn", 63, 277)
DLX_TEXPAND = MicrocodedImpl("DLX Texpand", 1, 100)

PICOJAVA_ASSEMBLY = MicrocodedImpl("PicoJava II trellis assembly fn", 41, 255)
PICOJAVA_TEXPAND = MicrocodedImpl("PicoJava II Texpand", 1, 102)

NIOS = {
    "f": (NiosImpl("NIOS II/f A.L.T.F", 59), NiosImpl("NIOS II/f C.I", 28)),
    "s": (NiosImpl("NIOS II/s A.L.T.F", 59), NiosImpl("NIOS II/s C.I", 35)),
    "e": (NiosImpl("NIOS II/e A.L.T.F", 264), NiosImpl("NIOS II/e C.I", 151)),
}

PAPER_BITS = 12  # the tables' operating point
PAPER_CALLS = 19
FIG3_BITS = (12, 24, 36, 48, 60)

# The paper's published numbers (its improvement percentages are printed
# truncated: Table III's 236.63 as 236, Table V's 68.57 as 68.5).
PAPER_TABLE3 = {"assembly_total_mi": 6460, "assembly_total_cycles": 25840,
                "texpand_total_mi": 1919, "texpand_total_cycles": 7676,
                "improvement_pct": 236}
PAPER_TABLE4 = {"assembly_total_mi": 5624, "assembly_total_cycles": 22496,
                "texpand_total_mi": 1957, "texpand_total_cycles": 7828,
                "improvement_pct": 187}
PAPER_TABLE5 = {"f": {"assembly_total_cycles": 1121, "ci_total_cycles": 532,
                      "improvement_pct": 110.7},
                "s": {"assembly_total_cycles": 1121, "ci_total_cycles": 665,
                      "improvement_pct": 68.5},
                "e": {"assembly_total_cycles": 5016, "ci_total_cycles": 2869,
                      "improvement_pct": 74.8}}


def improvement_pct(base_cycles: float, fast_cycles: float) -> float:
    """The paper's '%age Improvement' = (base - fast) / fast * 100."""
    return (base_cycles - fast_cycles) / fast_cycles * 100.0


def calls_for_bits(coded_bits: int, code: ConvCode = CODE_K3_STD) -> int:
    return paper_expansion_calls(coded_bits, code)


def _microcoded_table(assembly: MicrocodedImpl, texpand: MicrocodedImpl) -> Dict[str, float]:
    calls = PAPER_CALLS
    return {
        "assembly_total_mi": assembly.total_mi(calls),
        "assembly_total_cycles": assembly.total_cycles(calls),
        "texpand_total_mi": texpand.total_mi(calls),
        "texpand_total_cycles": texpand.total_cycles(calls),
        "improvement_pct": improvement_pct(assembly.total_cycles(calls),
                                           texpand.total_cycles(calls)),
        "speedup": assembly.total_cycles(calls) / texpand.total_cycles(calls),
    }


def table3() -> Dict[str, float]:
    return _microcoded_table(DLX_ASSEMBLY, DLX_TEXPAND)


def table4() -> Dict[str, float]:
    return _microcoded_table(PICOJAVA_ASSEMBLY, PICOJAVA_TEXPAND)


def table5() -> Dict[str, Dict[str, float]]:
    out = {}
    for ver, (base, ci) in NIOS.items():
        out[ver] = {
            "assembly_total_cycles": base.total_cycles(PAPER_CALLS),
            "ci_total_cycles": ci.total_cycles(PAPER_CALLS),
            "improvement_pct": improvement_pct(
                base.total_cycles(PAPER_CALLS), ci.total_cycles(PAPER_CALLS)),
        }
    return out


def cycle_model_sweep() -> List[Dict]:
    """Fig. 3's model rows: cycles against coded bits, each processor with
    and without the custom instruction."""
    rows = []
    for bits in FIG3_BITS:
        calls = calls_for_bits(bits)
        rows.append({
            "coded_bits": bits,
            "expansion_calls": calls,
            "dlx_assembly_cycles": DLX_ASSEMBLY.total_cycles(calls),
            "dlx_texpand_cycles": DLX_TEXPAND.total_cycles(calls),
            "picojava_assembly_cycles": PICOJAVA_ASSEMBLY.total_cycles(calls),
            "picojava_texpand_cycles": PICOJAVA_TEXPAND.total_cycles(calls),
            "nios_f_assembly_cycles": NIOS["f"][0].total_cycles(calls),
            "nios_f_ci_cycles": NIOS["f"][1].total_cycles(calls),
        })
    return rows


def fig4_improvement_pct() -> Dict[str, float]:
    """Fig. 4's processor rows: the improvement at the paper's 19 calls."""
    calls = PAPER_CALLS
    rows = {
        "DLX": (DLX_ASSEMBLY, DLX_TEXPAND),
        "PicoJava II": (PICOJAVA_ASSEMBLY, PICOJAVA_TEXPAND),
        **{f"NIOS II/{ver}": NIOS[ver] for ver in ("f", "s", "e")},
    }
    return {name: improvement_pct(base.total_cycles(calls), fast.total_cycles(calls))
            for name, (base, fast) in rows.items()}


def _printed(value: float, like) -> float:
    """``value`` truncated to the decimals the paper prints ``like`` with."""
    decimals = len(repr(like).partition(".")[2]) if isinstance(like, float) else 0
    scale = 10 ** decimals
    return math.floor(value * scale) / scale


def matches_paper(got: Dict, paper: Dict) -> bool:
    """Counts equal the paper's exactly; percentages equal it as printed."""
    for key, want in paper.items():
        if isinstance(want, dict):
            if not matches_paper(got[key], want):
                return False
        elif key == "improvement_pct":
            if _printed(got[key], want) != want:
                return False
        elif got[key] != want:
            return False
    return True


def run() -> Dict:
    tables = {"table3": table3(), "table4": table4(), "table5": table5()}
    check = {name: matches_paper(tables[name], paper) for name, paper in (
        ("table3", PAPER_TABLE3), ("table4", PAPER_TABLE4), ("table5", PAPER_TABLE5))}
    return {**tables, "fig3_cycle_model": cycle_model_sweep(),
            "fig4_improvement_pct": fig4_improvement_pct(), "matches_paper": check}


def main() -> int:
    out = run()
    print(json.dumps(out))
    return 0 if all(out["matches_paper"].values()) else 1


if __name__ == "__main__":
    sys.exit(main())
