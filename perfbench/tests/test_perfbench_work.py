"""The read-once work count of a solve, by hand at a small shape."""
import perfbench_tiny  # noqa: F401  (paths)
from perfbench import work


def test_solve_work_by_hand():
    # 2 queries of 3 and 2 words, 4 docs, 10 nonzeros, 6 distinct words,
    # 2 iterations
    w = work.solve_work(words=[3, 2], num_docs=4, nnz=10, distinct_words=6,
                        max_iter=2)
    q3 = 2 * (10 * 13 + 3 * 4) + (10 * 13 + 3 * 3 * 4)
    q2 = 2 * (10 * 9 + 2 * 4) + (10 * 9 + 3 * 2 * 4)
    assert w["flops"] == q3 + q2
    assert w["bytes"] == 2 * 5 * 6 * 4 + 10 * 8 + 5 * 4 + 2 * 4 * 4


def test_least_seconds_names_the_bound():
    t, by = work.least_seconds({"flops": 67e12, "bytes": 1.0})
    assert by == "operations" and abs(t - 1.0) < 1e-12
    t, by = work.least_seconds({"flops": 1.0, "bytes": 3.35e12})
    assert by == "bytes" and abs(t - 1.0) < 1e-12


def test_a_cells_batch_is_operation_bound():
    w = work.solve_work(words=[19] * 16, num_docs=1_310_720,
                        nnz=45_000_000, distinct_words=100_000, max_iter=15)
    t, by = work.least_seconds(w)
    assert by == "operations" and 0.010 < t < 0.020
