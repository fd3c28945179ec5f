"""Workload drivers, one a kind of traffic (`traffic/<mix>.json`'s
`driver`): set-up, window and check."""
