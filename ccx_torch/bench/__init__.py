"""Benchmark-corpus helpers (scenario generator lives here so the bench,
the tests and the tools import ONE seeded source of adversarial
workloads)."""
