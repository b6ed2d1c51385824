"""The trace's reduction on a hand-made trace: what the card ran, what
launched it, and the check's copies taken off the window's clock."""
import numpy as np

from portbench.harness.trace import CHECK_SPAN, WINDOWS_SPAN, Trace, \
    base_name

I64 = np.int64


def trace(cut=((60, 70),)):
    # host: a window of the job 0-50 launching k1 (corr 1) at 10 and a
    # fold (corr 2) at 40; the check's copy 60-70 launching a copy
    # (corr 3) at 61; a set-up launching k2 (corr 4) at 80
    host = [("portbench.window", 0, 100, 0), (WINDOWS_SPAN, 0, 50, 0),
            ("cudaLaunchKernel", 10, 11, 1), ("cudaLaunchKernel", 40, 41, 2),
            (CHECK_SPAN, 60, 70, 0), ("cudaMemcpyAsync", 61, 62, 3),
            ("portbench.job_setup", 75, 95, 0),
            ("cudaLaunchKernel", 80, 81, 4)]
    # device: k1 12-45, fold 52-55 (launched inside the window span, run
    # after it), the copy 62-69, k2 85-90
    dev = [("void k1<1>(int)", 12, 45, 1, 0), ("fold", 52, 55, 2, 0),
           ("Memcpy DtoH (Device -> Pageable)", 62, 69, 3, 0),
           ("k2", 85, 90, 4, 0)]
    col = list(zip(*dev))
    hcol = list(zip(*host))
    return Trace((0, 100), list(col[0]), *(np.asarray(c, I64)
                                          for c in col[1:]),
                 list(hcol[0]), *(np.asarray(c, I64) for c in hcol[1:]),
                 cut=np.asarray(cut, I64).reshape(-1, 2))


def test_launched_in_follows_the_correlation():
    tr = trace()
    assert tr.launched_in(WINDOWS_SPAN).tolist() == [True, True, False,
                                                     False]
    assert tr.launched_in(CHECK_SPAN).tolist() == [False, False, True,
                                                   False]


def test_the_check_is_off_the_clock():
    tr = trace()
    assert tr.window_s == 90e-9
    # busy: 12-45, 52-55, 62-69 (inside the cut 60-70), 85-90; the cut
    # counts as neither busy nor window
    assert tr.busy_s() == (33 + 3 + 5) * 1e-9
    # the idle stretches, longest first: the cut is none of them
    assert [round(g * 1e9) for _, g in tr.idle_gaps()] == [15, 12, 10, 7, 5]
    assert [base_name(n) for n in tr.dev_name] == ["k1", "fold",
                                                   "Memcpy DtoH", "k2"]
