"""The tonemap-and-quantize kernel's table of level edges
(``kernels/quantize.py``: ``table_from_changes``, ``pack_table``), on the CPU.

The kernel (``csrc/quantize.cu``) looks a finite x >= +0 up in a table made
on the card from the card's own chain, and sends everything else, and the
windows where the chain steps back, to the exact chain. Here the same method
runs in plain torch on the CPU's chain (``tonemap_quantize_reference`` on CPU
tensors, whose ``pow`` may round otherwise than the card's, so its edges are
its own): the edges by bisection on the bit patterns, then every pattern
within RADIUS of each scanned for the changes and windows, then the
package's ``table_from_changes`` and ``pack_table``. Two lookups are held to
the CPU chain, value for value:

* the definition: the count of edges <= x's bit pattern, the exact chain in
  the windows and off the finite x >= +0;
* the kernel's: the piece's count, one compare with the next edge, the
  window ends, exactly as ``csrc/quantize.cu:table_level`` reads the packed
  words;

on a strided sweep of the bit patterns of [0, 4), of the finite floats
above and of the negative half; on +-8 patterns around every edge; on -0,
negatives, subnormals, FLT_MAX, +-inf and NaN payloads. The card holds the
kernel to its plain version on all 2^32 inputs (``chip_smoke.py`` phase 30).
"""

import numpy as np
import pytest
import torch

from gpgpuraytrace_tpu_torch.kernels import quantize as kq

torch.set_num_threads(2)

RADIUS = 2048
STRIDE = 4099
FOUR = 0x40800000  # the bit pattern of 4.0


def chain(bits) -> torch.Tensor:
    """The CPU chain's level of each bit pattern (int64 in [0, 2^32))."""
    bits = torch.as_tensor(np.asarray(bits, dtype=np.int64))
    signed = torch.where(bits >= 1 << 31, bits - (1 << 32), bits)
    x = signed.to(torch.int32).view(torch.float32)
    return kq.tonemap_quantize_reference(x).to(torch.int64)


def cpu_changes():
    """(pattern, level) where the CPU chain's level changes: e_k by bisection
    for k = 1 .. 255 (the least pattern whose level is >= k, if the chain
    were monotone), then every pattern within RADIUS of each, the chain
    taken as constant between those neighbourhoods (the sweeps check it)."""
    k = torch.arange(1, kq.LEVELS, dtype=torch.int64)
    lo = torch.zeros_like(k)
    hi = torch.full_like(k, kq.FINITE)
    while bool((lo < hi).any()):
        mid = (lo + hi) // 2
        up = chain(mid) >= k
        hi = torch.where(up, mid, hi)
        lo = torch.where(up, lo, mid + 1)
    near = (lo[:, None] + torch.arange(-RADIUS, RADIUS + 1)).clamp(0, kq.FINITE - 1)
    patterns = torch.unique(near)
    levels = chain(patterns)
    before = torch.cat([torch.zeros(1, dtype=torch.int64), levels[:-1]])
    change = levels != before
    return list(zip(patterns[change].tolist(), levels[change].tolist()))


@pytest.fixture(scope="module")
def table():
    changes = cpu_changes()
    edges, ends, windows = kq.table_from_changes(changes)
    return {"changes": changes, "edges": edges, "ends": ends, "windows": windows,
            "words": torch.from_numpy(kq.pack_table(edges, ends).view(np.int32))}


def by_definition(t, bits: torch.Tensor) -> torch.Tensor:
    """The count of edges <= each pattern; the exact chain in the windows
    and for patterns that are not a finite x >= +0."""
    edges = torch.tensor(t["edges"][1:], dtype=torch.int64)
    level = torch.searchsorted(edges, bits, right=True)
    ends = torch.tensor(t["ends"], dtype=torch.int64)
    edge_of = torch.tensor(t["edges"], dtype=torch.int64)
    exact = (bits >= kq.FINITE) | (bits < ends[level.clamp(max=kq.LEVELS - 1)])
    assert bool((bits[~exact] >= edge_of[level[~exact]]).all())
    return torch.where(exact, chain(bits), level)


def as_kernel(t, bits: torch.Tensor) -> torch.Tensor:
    """``csrc/quantize.cu:table_level`` and ``level_of`` on the packed words."""
    words = t["words"].to(torch.int64).bitwise_and(0xFFFFFFFF)
    base, pieces = int(words[0]), int(words[1])
    edge = words[kq.HEADER_WORDS:kq.HEADER_WORDS + kq.EDGE_WORDS]
    window_end = words[kq.HEADER_WORDS + kq.EDGE_WORDS:kq.PIECE_WORDS]
    piece = t["words"][kq.PIECE_WORDS:].view(torch.uint8)[:pieces].to(torch.int64)
    i = ((bits >> kq.PIECE_SHIFT) - base).clamp(0, pieces - 1)
    k0 = piece[i]
    k = k0 + (bits >= edge[k0 + 1]).to(torch.int64)
    exact = (bits >= kq.FINITE) | (bits < window_end[k.clamp(max=kq.LEVELS - 1)])
    return torch.where(exact, chain(bits), k)


def sweep(name: str, t) -> torch.Tensor:
    if name == "below_4":
        return torch.arange(0, FOUR, STRIDE, dtype=torch.int64)
    if name == "finite_above_4":
        return torch.arange(FOUR, kq.FINITE, STRIDE, dtype=torch.int64)
    if name == "negative_half":
        return torch.arange(0x80000000, 1 << 32, 16 * STRIDE + 3, dtype=torch.int64)
    if name == "around_edges":
        edges = torch.tensor(t["edges"][1:], dtype=torch.int64)
        return (edges[:, None] + torch.arange(-8, 9)).flatten()
    specials = np.array([
        -0.0, -1e-45, -1e-30, -0.5, -1.0, -1.0000001, -2.0, -1e30, -3.4028235e38,
        1e-45, 2e-45, 1e-40, 1.1754942e-38, 1.1754944e-38, 3.4028235e38, np.inf, -np.inf,
    ], dtype=np.float32).view(np.uint32).astype(np.int64)
    nans = [0x7FC00000, 0x7F800001, 0x7FFFFFFF, 0x7FA00000, 0xFFC00000, 0xFF800001, 0xFFFFFFFF]
    return torch.tensor(specials.tolist() + nans, dtype=torch.int64)


@pytest.mark.parametrize("name", ["below_4", "finite_above_4", "negative_half", "around_edges",
                                  "specials"])
def test_edge_table_matches_cpu_chain(table, name):
    """Both lookups equal the CPU chain value for value."""
    bits = sweep(name, table)
    want = chain(bits)
    assert torch.equal(by_definition(table, bits), want)
    assert torch.equal(as_kernel(table, bits), want)


def test_cpu_table_is_whole(table):
    """255 strictly rising edges, each in a piece of its own, the windows
    inside the scanned neighbourhoods; the count of windows is reported."""
    edges, ends = table["edges"], table["ends"]
    assert edges[0] == 0 and all(a < b for a, b in zip(edges[1:], edges[2:]))
    assert all(e <= w for e, w in zip(edges, ends))
    pieces = [e >> kq.PIECE_SHIFT for e in edges[1:]]
    assert len(set(pieces)) == kq.LEVELS - 1
    for start, end in table["windows"]:
        k = max(i for i, e in enumerate(edges) if e <= start)
        assert edges[k] < start < end <= ends[k] and end - edges[k] <= RADIUS
    print(f"CPU chain: {len(table['changes'])} changes, {len(table['windows'])} windows")


def test_table_from_changes_edges_and_windows():
    """A chain that jumps two levels at once, steps back twice after an
    edge and once more inside a level, and ends at 255."""
    changes = [(10, 1), (20, 3), (21, 2), (22, 3), (23, 2), (24, 3), (40, 4), (50, 3),
               (60, 4)] + [(100 + k, k) for k in range(5, 256)]
    edges, ends, windows = kq.table_from_changes(changes)
    assert edges[:6] == [0, 10, 20, 20, 40, 105]
    assert ends[:6] == [0, 10, 20, 24, 60, 105]
    assert windows == [(21, 22), (23, 24), (50, 60)]
    assert edges[255] == ends[255] == 355


def test_table_from_changes_window_to_the_end():
    """A chain that leaves its top level and never comes back sends the rest
    of the finite range to the exact chain."""
    changes = [(k, k) for k in range(1, 256)] + [(1000, 254)]
    edges, ends, windows = kq.table_from_changes(changes)
    assert windows == [(1000, kq.FINITE)] and ends[255] == kq.FINITE


@pytest.mark.parametrize("changes, match", [
    ([(5, 1), (5, 2)], "order"),
    ([(5, 1), (3, 2)], "order"),
    ([(kq.FINITE, 1)], "order"),
    ([(5, 256)], "range"),
    ([(k, k) for k in range(1, 255)], "reach 254"),
])
def test_table_from_changes_rejects(changes, match):
    with pytest.raises(ValueError, match=match):
        kq.table_from_changes(changes)


def test_pack_table_layout_and_one_edge_a_piece():
    """The header, the sentinels, the window ends and the pieces' counts;
    two edges in one piece are refused."""
    edges = [0] + [(0x30000000 + (k << kq.PIECE_SHIFT)) for k in range(1, kq.LEVELS)]
    ends = list(edges)
    ends[7] += 3
    words = kq.pack_table(edges, ends)
    assert words.dtype == np.uint32 and len(words) % 4 == 0
    base = edges[1] >> kq.PIECE_SHIFT
    assert words[0] == base and words[1] == kq.LEVELS - 1
    assert list(words[kq.HEADER_WORDS:kq.HEADER_WORDS + kq.LEVELS]) == edges
    assert (words[kq.HEADER_WORDS + kq.LEVELS:kq.HEADER_WORDS + kq.EDGE_WORDS]
            == 0xFFFFFFFF).all()
    assert list(words[kq.HEADER_WORDS + kq.EDGE_WORDS:kq.PIECE_WORDS]) == ends
    assert list(words[kq.PIECE_WORDS:].view(np.uint8)[:kq.LEVELS - 1]) == list(range(255))
    crowded = list(edges)
    crowded[9] = crowded[8] + 1
    with pytest.raises(ValueError, match="holds 2 edges"):
        kq.pack_table(crowded, crowded)
