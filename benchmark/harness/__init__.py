"""The harness: cells and loops found by name, the trace, the check, the result line."""
