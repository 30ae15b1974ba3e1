"""The roll-chain kernel's plan and source, on the CPU (no card).

``smi_tpu_torch/kernels/csrc/roll_chain.cu`` runs only on a CUDA card
(``tests/test_torch_gpu.py``, ``chip_smoke.py`` phases 28-30). Here its
plan (``roll.plan``) is held to the kernel's layout, walked as the
kernel walks it: warp ``w = b * warps + i`` (warp ``i`` of block ``b``)
owns line ``w % lines`` of chain ``w // lines``, and lane ``l`` holds
element ``32 k + l`` of the line in register ``k``. The source's limits
are held to the wrapper's, and the first form's plan
(``chip_smoke.earlier_roll_plan``) to what that form launched.
"""

import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest

from smi_tpu_torch.kernels import _build
from smi_tpu_torch.kernels import roll

ROOT = Path(__file__).resolve().parents[1]
SOURCE = (_build.CSRC / "roll_chain.cu").read_text()

#: the shapes the kernel runs at: chip_smoke.py's and the card tests'
#: (512x2048 x1, 256x2048 x2, 7x300 x3) and the CPU surface's (16x256,
#: 32x128, and their half-height arrays at two chains)
PLAN_CASES = [((512, 2048), 1), ((256, 2048), 2), ((7, 300), 3),
              ((16, 256), 1), ((32, 128), 1), ((8, 256), 2),
              ((16, 128), 2)]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    return chip_smoke


def _reads(p, shape, body, chains):
    """How often the kernel reads each element of each chain under plan
    ``p``; asserts that each read lands at its place along the rolled
    axis of its line."""
    rows, cols = shape
    counts = np.zeros((chains, rows * cols), np.int64)
    slots = (32 * np.arange(p["regs"])[:, None] + np.arange(32)).ravel()
    e = slots[slots < p["axis"]]
    for block in range(p["blocks"]):
        for i in range(p["warps"]):
            warp = block * p["warps"] + i
            if warp >= chains * p["lines"]:
                continue
            chain, line = divmod(warp, p["lines"])
            offset = line * p["line_stride"] + e * p["elem_stride"]
            row, col = np.divmod(offset, cols)
            along, across = (row, col) if body == "sublane" else (col, row)
            assert (along == e).all() and (across == line).all()
            np.add.at(counts[chain], offset, 1)
    return counts


@pytest.mark.parametrize("shape,ilp", PLAN_CASES)
@pytest.mark.parametrize("body", ["lane", "sublane", "add"])
def test_plan_covers_every_line_of_every_chain_once(body, shape, ilp):
    """Each element of every chain is read (and written) by exactly one
    lane of one warp, at its place along its line, and no block is left
    without a line; a line's data registers stay within ``MAX_REGS``,
    under the 255 a thread may have, the least power of two that holds
    it."""
    p = roll.plan(*shape, ilp, body)
    assert (_reads(p, shape, body, ilp) == 1).all()
    assert (p["blocks"] - 1) * p["warps"] < ilp * p["lines"]
    assert p["regs"] <= roll.MAX_REGS < 255
    assert p["regs"] & (p["regs"] - 1) == 0
    assert 32 * p["regs"] >= p["axis"] and (p["regs"] == 1
                                           or 16 * p["regs"] < p["axis"])


@pytest.mark.parametrize("chains", [1, 2, 3, 4])
@pytest.mark.parametrize("body", ["lane", "sublane", "add"])
def test_an_axis_beyond_the_limit_is_refused(body, chains):
    """4096 elements along the rolled axis (128 registers of 32) at any
    number of chains; one more is refused, the message naming the
    limit."""
    limit = roll.MAX_AXIS
    assert limit == 4096
    at = (limit, 3) if body == "sublane" else (3, limit)
    p = roll.plan(*at, chains, body)
    assert p["axis"] == limit and p["regs"] == roll.MAX_REGS
    beyond = (limit + 1, 3) if body == "sublane" else (3, limit + 1)
    with pytest.raises(ValueError, match="limit of 4096 elements"):
        roll.plan(*beyond, chains, body)


def test_the_source_and_the_wrapper_agree_on_the_limits():
    for name, value in (("kMaxRegs", roll.MAX_REGS),
                        ("kMaxWarps", roll.WARPS),
                        ("kMaxChains", roll.MAX_CHAINS)):
        match = re.search(rf"constexpr int {name} = (\d+);", SOURCE)
        assert match and int(match.group(1)) == value, name
    for body, code in roll.BODIES.items():
        name = {"lane": "kLane", "sublane": "kSublane", "add": "kAdd"}[body]
        assert f"constexpr int {name} = {code};" in SOURCE


def test_the_step_loop_has_no_shared_memory_and_no_barrier():
    """Every step stays in registers: no shared memory, no block
    barrier; a rotation moves each element by a warp shuffle, and the
    step loops are not unrolled (one loop on whole lines, one on short
    lines, one for the add)."""
    code = re.sub(r"//[^\n]*", "", SOURCE)
    assert "__shared__" not in code and "__syncthreads" not in code
    assert "__shfl_sync" in code
    assert code.count("#pragma unroll 1\n") == 3


@pytest.mark.parametrize("shape,ilp,body,tile,blocks", [
    ((512, 2048), 1, "lane", (4, 2048), 128),
    ((256, 2048), 2, "lane", (2, 2048), 128),
    ((512, 2048), 1, "sublane", (512, 16), 128),
    ((256, 2048), 2, "sublane", (256, 16), 128),
    ((512, 2048), 1, "add", (4, 2048), 128),
    ((7, 300), 3, "lane", (7, 300), 1),
    ((33, 5), 1, "sublane", (33, 5), 1),
])
def test_the_earlier_plan_is_the_first_forms(shape, ilp, body, tile,
                                             blocks):
    """``chip_smoke.earlier_roll_plan``: the first, shared-memory form's
    tiles (the rolled axis whole, about 8192 elements a block), which its
    C entry takes in place of the registers and warps."""
    p = _chip_smoke().earlier_roll_plan(*shape, ilp, body)
    assert p["tile"] == tile and p["args"] == tile
    assert p["blocks"] == blocks


def test_earlier_roll_source_takes_its_own_plan(monkeypatch):
    """``chip_smoke.py --earlier .../roll_chain.cu``: while the earlier
    source is swapped in, the wrapper asks for the first form's plan and
    its library; after, the tree's again."""
    chip_smoke = _chip_smoke()
    tree_lib, earlier_lib = object(), object()
    monkeypatch.setitem(_build._libs, "roll_chain", tree_lib)
    source = object.__new__(chip_smoke.EarlierSource)
    source.stem, source.lib = "roll_chain", earlier_lib
    with source.swapped():
        assert _build._libs["roll_chain"] is earlier_lib
        assert roll._plan(512, 2048, 1, "lane")["args"] == (4, 2048)
    assert _build._libs["roll_chain"] is tree_lib
    assert roll._plan(512, 2048, 1, "lane")["args"] == (64, 4)
