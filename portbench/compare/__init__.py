"""One module a number compared with the reference, found by the names
in limits/<cell>.json.

A module defines read(got, want) -> float: the number for one kept
iteration, from the program's outputs in the reference's layout (`got`,
the reference's view) and the reference's own (`want`), both dicts of
tensors; inf where `got` lacks what the number reads. A run is correct
where each number's worst over the kept iterations is at most its limit.
"""
