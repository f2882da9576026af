"""The TRSV sweep's handoff of x between CTAs, on the CPU.

The kernel (csrc/trsv.cu) runs only on a card, where
tests/test_torch_cuda.py holds its bits, a grid beyond the card and its
trap. Here: what its source promises (tagged words, each load its own
wait, no fence or counter on the hop, every wait bounded, the debug and
test builds' macros out of the main path's library), the scratch layout
and launch the wrapper hands the C entry, the step counter, and the build
of a source with macros as a library of its own.
"""

import re
from pathlib import Path

import pytest
import torch

from accblas_tpu_torch.ops import _build
from accblas_tpu_torch.ops import trsv as ttrsv

SRC = Path(ttrsv.__file__).resolve().parent.parent / "csrc" / "trsv.cu"


def _code() -> str:
    return re.sub(r"//[^\n]*", "", SRC.read_text())


def _sweep_section(code: str) -> str:
    return code[code.index("using Word"):code.index("cudaError_t with_sweep")]


@pytest.mark.parametrize("token", ["st.release", "ld.acquire", "__threadfence", "__ldcg",
                                   "__stcg", "wait_published", "done"])
def test_the_hop_has_no_fence_counter_or_second_read(token):
    assert not re.search(rf"\b{re.escape(token)}", _sweep_section(_code())), token


def test_x_is_published_and_taken_as_tagged_words():
    sweep = _sweep_section(_code())
    assert "st.relaxed.gpu.global.b64" in sweep and "ld.relaxed.gpu.global.v2.b64" in sweep
    assert "constexpr Word kTag = Word{1} << 32;" in sweep
    # a warp reads a block's 64 words, two a lane, votes on their tags and
    # shuffles each thread its columns
    assert "p + 2 * (threadIdx.x & 31)" in sweep
    assert "__all_sync(kFull" in sweep and "__shfl_sync(kFull" in sweep
    # the only atomic is the ticket
    assert sweep.count("atomicAdd(") == 1 and "atomicAdd(tickets + blockIdx.y, 1u)" in sweep
    # no barrier between the x words' stores and the end of the hop
    tail = sweep[sweep.index("publish(xhi + o"):]
    assert "__syncthreads" not in tail


def test_every_wait_is_bounded_and_traps():
    sweep = _sweep_section(_code())
    # every poll of every wait is counted in one place, to kMaxPolls
    assert len(re.findall(r"\bpolls == kMaxPolls\b", sweep)) == 1
    assert "__trap();" in sweep and "trapping" in sweep
    assert "#define ACCBLAS_TRSV_MAX_POLLS (1u << 21)" in _code()


def test_debug_and_test_builds_stay_out_of_the_library():
    """Without ACCBLAS_TRSV_STAMPS the stamps expand to nothing, and the
    withheld publication exists only under ACCBLAS_TRSV_WITHHOLD."""
    code = _code()
    plain = code.split("#ifdef ACCBLAS_TRSV_STAMPS", 1)[1].split("#else", 1)[1]
    plain = plain.split("#endif", 1)[0]
    empty = r"\s*\\\s*do \{\s*\\\s*\} while \(0\)\s*"
    assert re.fullmatch(r"\s*#define TRSV_STAMPS_AT\(nr, t\)" + empty
                        + r"#define TRSV_STAMP\(slot, value\)" + empty, plain), plain
    withhold = code.index("ACCBLAS_TRSV_WITHHOLD)")
    assert code.rindex("#ifdef ACCBLAS_TRSV_WITHHOLD", 0, withhold) > code.rindex(
        "#endif", 0, withhold)
    assert code.count("g_stamps") == code.count("g_stamps", code.index(
        "#ifdef ACCBLAS_TRSV_STAMPS"))


@pytest.mark.parametrize("k,panels", [(1, 1), (2, 1), (4, 1), (5, 2), (8, 2), (64, 16)])
def test_panels_and_scratch(k, panels):
    assert ttrsv.sweep_panels(k) == panels
    assert ttrsv.sweep_scratch_bytes(k, 512, False) == 8 * k * 512 + 4 * panels
    assert ttrsv.sweep_scratch_bytes(k, 512, True) == 16 * k * 512 + 4 * panels


@pytest.fixture
def fake_entry(monkeypatch):
    """The wrapper's launch on the CPU with a stand-in for the C entry: the
    arguments it was handed."""
    calls = []

    def entry(*args):
        calls.append(args)
        return 0

    monkeypatch.setattr(_build, "on_device", lambda t: _build._CURRENT)
    monkeypatch.setattr(_build, "stream", lambda t: 0)
    return entry, calls


@pytest.mark.parametrize("n,k,ar", [(100, 1, "f32"), (1000, 8, "df64"), (64, 5, "f32")])
def test_the_launch_hands_one_scratch_and_counts_its_steps(fake_entry, monkeypatch, n, k, ar):
    entry, calls = fake_entry
    nb = -(-n // ttrsv.BLOCK)
    npad = nb * ttrsv.BLOCK
    inv = torch.zeros(nb * ttrsv.BLOCK // ttrsv.LEAF, ttrsv.LEAF, ttrsv.LEAF).transpose(1, 2)
    bt = torch.zeros(k, npad)
    a = torch.zeros(n, n)
    sizes = []
    real_empty = torch.empty

    def empty(*shape, **kw):
        t = real_empty(*shape, **kw)
        if kw.get("dtype") is torch.uint8:
            sizes.append(t.numel())
        return t

    monkeypatch.setattr(torch, "empty", empty)
    launches, steps = ttrsv.sweep_launches, ttrsv.sweep_steps
    out = ttrsv._trsv_sweep_cuda(a, inv, bt, False, ar, torch.float32, entry=entry)
    assert out.shape == (n, k)
    assert ttrsv.sweep_launches == launches + 1
    assert ttrsv.sweep_steps == steps + -(-n // ttrsv.LEAF) * ttrsv.sweep_panels(k)
    (args,) = calls
    assert len(args) == len(ttrsv._SWEEP_ARGTYPES) == 14
    assert sizes == [ttrsv.sweep_scratch_bytes(k, npad, ar == "df64")]
    assert args[6] == k and args[11] == int(ar == "df64")


def test_macros_build_a_library_of_their_own():
    plain = _build._lib_path("trsv")
    stamped = _build._lib_path("trsv", ("ACCBLAS_TRSV_STAMPS",))
    assert stamped != plain and stamped.parent == plain.parent
    assert stamped == _build._lib_path("trsv", ("ACCBLAS_TRSV_STAMPS",))
    assert _build._lib_path("trsv", ("ACCBLAS_TRSV_MAX_POLLS=4096",)) not in (plain, stamped)
    assert _build._define_flags(("A", "B=2")) == ["-DA", "-DB=2"]
