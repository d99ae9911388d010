"""Test harnesses that ship with the port (the differential plan fuzzer)."""
