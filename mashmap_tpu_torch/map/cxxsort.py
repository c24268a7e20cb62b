"""Exact emulation of libstdc++ ``std::sort`` (GNU introsort).

Why this exists: the reference collapses each merged chain onto the
chain's FIRST mapping after ``std::sort`` by splitMappingId
(computeMap.hpp:1646-1698). ``std::sort`` is NOT stable, so which
fragment's ``conservedSketches`` (PAF column 10) survives — and the
float accumulation ORDER of the chain's nucIdentity / kmerComplexity
means — is an artifact of libstdc++'s introsort permutation on
equal keys. That permutation is fully deterministic, so bit-parity is
achievable by replaying the exact algorithm: ``__introsort_loop``
(median-of-3 quicksort, threshold 16, depth limit 2*floor(log2 n),
heap-sort fallback) followed by ``__final_insertion_sort``
(bits/stl_algo.h of the GCC toolchain this image's oracle binary is
built with; verified element-for-element against a compiled driver in
tests/test_cxxsort.py).

Only the features ``std::sort`` itself uses are implemented; the
comparator is strictly less-than on integer keys, and elements move as
(key, payload) pairs exactly like the reference's 26-field structs.
"""

from __future__ import annotations

from typing import List, Tuple

_THRESHOLD = 16  # _S_threshold in bits/stl_algo.h


def _lg(n: int) -> int:
    return n.bit_length() - 1


# ---------------------------------------------------------------- heap ops
# bits/stl_heap.h: __push_heap, __adjust_heap, __pop_heap, __make_heap,
# __sort_heap — operating on a[first:last] with hole indices relative to
# `first`. `a` holds (key, payload) tuples; comparisons use keys only.

def _push_heap(a, first, hole, top, value):
    parent = (hole - 1) // 2
    while hole > top and a[first + parent][0] < value[0]:
        a[first + hole] = a[first + parent]
        hole = parent
        parent = (hole - 1) // 2
    a[first + hole] = value


def _adjust_heap(a, first, hole, length, value):
    top = hole
    second = hole
    while second < (length - 1) // 2:
        second = 2 * (second + 1)
        if a[first + second][0] < a[first + second - 1][0]:
            second -= 1
        a[first + hole] = a[first + second]
        hole = second
    if (length & 1) == 0 and second == (length - 2) // 2:
        second = 2 * (second + 1)
        a[first + hole] = a[first + second - 1]
        hole = second - 1
    _push_heap(a, first, hole, top, value)


def _pop_heap(a, first, last, result):
    value = a[result]
    a[result] = a[first]
    _adjust_heap(a, first, 0, last - first, value)


def _make_heap(a, first, last):
    length = last - first
    if length < 2:
        return
    parent = (length - 2) // 2
    while True:
        value = a[first + parent]
        _adjust_heap(a, first, parent, length, value)
        if parent == 0:
            return
        parent -= 1


def _sort_heap(a, first, last):
    while last - first > 1:
        last -= 1
        _pop_heap(a, first, last, last)


def _partial_sort_full(a, first, last):
    # __partial_sort(first, middle=last, last): __heap_select is just
    # make_heap when middle == last, then sort_heap over the range
    _make_heap(a, first, last)
    _sort_heap(a, first, last)


# ------------------------------------------------------------- insertion
def _unguarded_linear_insert(a, last):
    val = a[last]
    nxt = last - 1
    while val[0] < a[nxt][0]:
        a[nxt + 1] = a[nxt]
        nxt -= 1
    a[nxt + 1] = val


def _insertion_sort(a, first, last):
    if first == last:
        return
    for i in range(first + 1, last):
        if a[i][0] < a[first][0]:
            val = a[i]
            # std::move_backward [first, i) -> [first+1, i+1)
            a[first + 1:i + 1] = a[first:i]
            a[first] = val
        else:
            _unguarded_linear_insert(a, i)


def _final_insertion_sort(a, first, last):
    if last - first > _THRESHOLD:
        _insertion_sort(a, first, first + _THRESHOLD)
        for i in range(first + _THRESHOLD, last):
            _unguarded_linear_insert(a, i)
    else:
        _insertion_sort(a, first, last)


# ------------------------------------------------------------- quicksort
def _move_median_to_first(a, result, i1, i2, i3):
    if a[i1][0] < a[i2][0]:
        if a[i2][0] < a[i3][0]:
            a[result], a[i2] = a[i2], a[result]
        elif a[i1][0] < a[i3][0]:
            a[result], a[i3] = a[i3], a[result]
        else:
            a[result], a[i1] = a[i1], a[result]
    elif a[i1][0] < a[i3][0]:
        a[result], a[i1] = a[i1], a[result]
    elif a[i2][0] < a[i3][0]:
        a[result], a[i3] = a[i3], a[result]
    else:
        a[result], a[i2] = a[i2], a[result]


def _unguarded_partition(a, first, last, pivot):
    while True:
        while a[first][0] < a[pivot][0]:
            first += 1
        last -= 1
        while a[pivot][0] < a[last][0]:
            last -= 1
        if not first < last:
            return first
        a[first], a[last] = a[last], a[first]
        first += 1


def _unguarded_partition_pivot(a, first, last):
    mid = first + (last - first) // 2
    _move_median_to_first(a, first, first + 1, mid, last - 1)
    return _unguarded_partition(a, first + 1, last, first)


def _introsort_loop(a, first, last, depth_limit):
    while last - first > _THRESHOLD:
        if depth_limit == 0:
            _partial_sort_full(a, first, last)
            return
        depth_limit -= 1
        cut = _unguarded_partition_pivot(a, first, last)
        _introsort_loop(a, cut, last, depth_limit)
        last = cut


def cxx_sort_perm(keys: List[int]) -> List[int]:
    """Indices of ``keys`` in the order GNU ``std::sort`` leaves them.

    ``sorted_payloads = [payloads[i] for i in cxx_sort_perm(keys)]``
    reproduces ``std::sort`` on an array of (key, payload) structs
    compared by key — including the exact placement of equal keys.
    """
    a: List[Tuple[int, int]] = [(k, i) for i, k in enumerate(keys)]
    n = len(a)
    if n > 1:
        _introsort_loop(a, 0, n, 2 * _lg(n))
        _final_insertion_sort(a, 0, n)
    return [p for _, p in a]
