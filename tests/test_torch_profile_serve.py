"""``launch/profile_serve.idle_share``: the device's idle share inside one
profiled run, from its device span, its busy time and the unprofiled run's
host wall.  Busy time above the span or the wall is named with its excess,
never clamped to an idle share of 0."""

import math

import pytest

from repro_torch.launch.profile_serve import idle_share


@pytest.mark.parametrize("span,busy,wall,share,note", [
    (1000.0, 750.0, 1200.0, 0.25, ""),
    (1000.0, 1000.0, 1000.0, 0.0, ""),
    (2000.0, 0.0, 2500.0, 1.0, ""),
    # busy above the unprofiled wall (the two runs differ), inside the span
    (50000.0, 45000.0, 40000.0, 0.1, "busy exceeds the unprofiled host wall by 5.000 ms"),
    # records overlap (more than one stream): busy above the span and the wall
    (30000.0, 39900.0, 20000.0, -0.33,
     "busy exceeds the device span by 9.900 ms; busy exceeds the unprofiled host wall by "
     "19.900 ms"),
])
def test_idle_share(span, busy, wall, share, note):
    got, said = idle_share(span, busy, wall)
    assert got == pytest.approx(share, abs=1e-12) and said == note


def test_idle_share_without_device_records_is_nan():
    share, note = idle_share(0.0, 0.0, 1000.0)
    assert math.isnan(share) and note == ""
