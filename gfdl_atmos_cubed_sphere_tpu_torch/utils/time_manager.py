"""Model calendar and time arithmetic, PyTorch port.

Counterpart of gfdl_atmos_cubed_sphere_tpu/utils/time_manager.py (the FMS
time_manager_mod equivalent): exact integer arithmetic on days and seconds
(no float drift over long runs), get_date/set_date on the JULIAN
(proleptic Gregorian leap rules), NOLEAP and THIRTY_DAY calendars, and
interval alarms for diagnostics, restarts and boundary updates. Pure
Python, no tensors.
"""

from dataclasses import dataclass

SECONDS_PER_DAY = 86400

JULIAN = "julian"
NOLEAP = "noleap"
THIRTY_DAY = "thirty_day"

_DAYS_NOLEAP = (31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31)


def _leap(y):
    return y % 4 == 0 and (y % 100 != 0 or y % 400 == 0)


def days_in_month(year, month, calendar=JULIAN):
    if calendar == THIRTY_DAY:
        return 30
    d = _DAYS_NOLEAP[month - 1]
    if calendar == JULIAN and month == 2 and _leap(year):
        d += 1
    return d


def days_in_year(year, calendar=JULIAN):
    if calendar == THIRTY_DAY:
        return 360
    if calendar == NOLEAP:
        return 365
    return 366 if _leap(year) else 365


@dataclass(frozen=True, order=True)
class Time:
    """Exact elapsed time: days + seconds, seconds in [0, 86400)."""
    days: int = 0
    seconds: int = 0

    def __post_init__(self):
        d, s = divmod(self.days * SECONDS_PER_DAY + self.seconds,
                      SECONDS_PER_DAY)
        object.__setattr__(self, "days", d)
        object.__setattr__(self, "seconds", s)

    def __add__(self, o):
        return Time(self.days + o.days, self.seconds + o.seconds)

    def __sub__(self, o):
        return Time(self.days - o.days, self.seconds - o.seconds)

    def __mul__(self, k):
        tot = (self.days * SECONDS_PER_DAY + self.seconds) * int(k)
        return Time(0, tot)

    __rmul__ = __mul__

    def total_seconds(self):
        return self.days * SECONDS_PER_DAY + self.seconds


def set_time(seconds=0, days=0):
    """FMS set_time(seconds, days)."""
    return Time(days, seconds)


def get_time(t: Time):
    """FMS get_time -> (seconds, days)."""
    return t.seconds, t.days


def set_date(year, month, day, hour=0, minute=0, second=0,
             calendar=JULIAN):
    """Date -> elapsed Time since year 1, Jan 1 00Z (FMS convention)."""
    days = 0
    for y in range(1, year):
        days += days_in_year(y, calendar)
    for m in range(1, month):
        days += days_in_month(year, m, calendar)
    days += day - 1
    return Time(days, hour * 3600 + minute * 60 + second)


def get_date(t: Time, calendar=JULIAN):
    """Elapsed Time -> (year, month, day, hour, minute, second)."""
    days = t.days
    year = 1
    while True:
        dy = days_in_year(year, calendar)
        if days < dy:
            break
        days -= dy
        year += 1
    month = 1
    while True:
        dm = days_in_month(year, month, calendar)
        if days < dm:
            break
        days -= dm
        month += 1
    hour, rem = divmod(t.seconds, 3600)
    minute, second = divmod(rem, 60)
    return year, month, days + 1, hour, minute, second


class Alarm:
    """Recurring event scheduler (diag/restart/BC intervals): fires when
    model time crosses the next multiple of `interval` past `start`."""

    def __init__(self, interval: Time, start: Time = Time()):
        self.interval = interval.total_seconds()
        self.next_s = start.total_seconds() + self.interval

    def is_ringing(self, t: Time):
        return t.total_seconds() >= self.next_s

    def reset(self, t: Time):
        while self.next_s <= t.total_seconds():
            self.next_s += self.interval
