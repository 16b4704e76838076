"""`chip_smoke.py`'s DeviceTimer attribution, on the CPU: how a profiler
session's device timeline is cut into regions by the runs of marker
kernels at each region's edges (`region_spans`), and what a region whose
record the profiler lost part of looks like (`whole`)."""

import chip_smoke

MARK = f"void {chip_smoke.MARK}(long)"
EDGE = [MARK] * chip_smoke.MARKS_PER_EDGE


def _timeline(regions):
    """Device kernel names of a session: padding, then per region a warm
    call outside it and its edge markers around its calls, then padding."""
    pad = ["fill"] * chip_smoke.PAD_KERNELS
    names = list(pad)
    for kernels in regions:
        names += ["warm"] + EDGE + kernels + EDGE
    return names + pad


def test_regions_are_the_kernels_between_their_marker_runs():
    regions = [["k1", "k1"], ["plain_a", "plain_b"], ["step"] * 3]
    names = _timeline(regions)
    spans = chip_smoke.region_spans(names, len(regions))
    assert [names[lo:hi] for _, lo, hi in spans] == regions
    assert all(names[first] == MARK for first, _, _ in spans)


def test_a_lost_marker_costs_no_region():
    """One marker record lost at any edge leaves every region's kernels
    where they were; a whole edge lost, or a region with no kernel left,
    makes the runs not pair up (the session is recorded again)."""
    regions = [["a"], ["b", "b"], ["c"]]
    names = _timeline(regions)
    for i, name in enumerate(names):
        if name != MARK:
            continue
        lost = names[:i] + names[i + 1:]
        spans = chip_smoke.region_spans(lost, len(regions))
        assert [lost[lo:hi] for _, lo, hi in spans] == regions, i
    first = names.index(MARK)
    whole_edge = names[:first] + names[first + chip_smoke.MARKS_PER_EDGE:]
    assert chip_smoke.region_spans(whole_edge, len(regions)) is None
    # the session's first and last records (its padding) lost: no matter
    pad = chip_smoke.PAD_KERNELS
    spans = chip_smoke.region_spans(names[pad - 1:-pad + 1], len(regions))
    assert spans is not None
    no_kernel = _timeline([["a"], [], ["c"]])
    assert chip_smoke.region_spans(no_kernel, 3) is None


def test_whole_needs_every_kernel_a_multiple_of_the_calls():
    assert chip_smoke.whole([(1.0, "k")] * 4 + [(2.0, "f")] * 4, 4)
    assert not chip_smoke.whole([(1.0, "k")] * 3, 4)
    assert not chip_smoke.whole([], 4)
