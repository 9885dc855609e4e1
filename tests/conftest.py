import os
import sys

# smoke tests and benches must see the single real device — the 512-device
# flag belongs ONLY to launch/dryrun.py
os.environ.pop("XLA_FLAGS", None)

# ...except for the sharded-aggregation parity tier (tests/test_agg_sharded):
# conftest owns XLA_FLAGS (popped above), so CI requests a multi-device host
# platform through REPRO_HOST_DEVICES and we translate it back before jax
# initialises — e.g. ``REPRO_HOST_DEVICES=4 pytest tests/test_agg_sharded.py``
_n = os.environ.get("REPRO_HOST_DEVICES")
if _n and _n != "1":
    os.environ["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={_n}"

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def hist_rec(history):
    """Float-hex HistoryPoint records for bit-exact history comparisons
    (shared by the sharded-parity and fault-injection suites; the golden
    fixtures use tests/golden/generate.history_record, the dict spelling
    of the same fields)."""
    return [(p.time.hex(), p.version, float(p.accuracy).hex(), p.n_updates,
             p.selected, p.up_bytes, p.down_bytes) for p in history]


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA card of compute capability (9, 0) (H100); "
        "the test skips itself elsewhere")
