"""Gregorian calendar intervals (reference interval.go:84-148).

The reference's one-shot ticker (interval.go:29-72) has no class here: its
role is played by the asyncio window_flush_loop heartbeat
(runtime/service.py).  Duration values 0-5 select a calendar
interval; expiry is the END of the current interval (e.g. for Minutes, the
last millisecond of the current minute).
"""
from __future__ import annotations

import calendar
from datetime import datetime, timedelta
GREGORIAN_MINUTES = 0
GREGORIAN_HOURS = 1
GREGORIAN_DAYS = 2
GREGORIAN_WEEKS = 3
GREGORIAN_MONTHS = 4
GREGORIAN_YEARS = 5


class GregorianError(ValueError):
    pass


def _to_ms(dt: datetime) -> int:
    return int(dt.timestamp() * 1000)


def gregorian_duration(now: datetime, d: int) -> int:
    """Entire duration of the Gregorian interval containing `now`, in ms
    (reference interval.go:84-109).

    Deviation from the reference: interval.go:99 has an operator-precedence
    bug for Months (`end.UnixNano() - begin.UnixNano()/1000000`); we return
    the intended (end - begin) in milliseconds.
    """
    if d == GREGORIAN_MINUTES:
        return 60_000
    if d == GREGORIAN_HOURS:
        return 3_600_000
    if d == GREGORIAN_DAYS:
        return 86_400_000
    if d == GREGORIAN_WEEKS:
        raise GregorianError("`Duration = GregorianWeeks` not yet supported")
    if d == GREGORIAN_MONTHS:
        days = calendar.monthrange(now.year, now.month)[1]
        return days * 86_400_000
    if d == GREGORIAN_YEARS:
        days = 366 if calendar.isleap(now.year) else 365
        return days * 86_400_000
    raise GregorianError(
        "behavior DURATION_IS_GREGORIAN is set; but `Duration` is not a valid "
        "gregorian interval"
    )


def gregorian_expiration(now: datetime, d: int) -> int:
    """End of the current Gregorian interval as unix ms
    (reference interval.go:117-148).  E.g. Minutes → last ms of this minute.
    """
    if d == GREGORIAN_MINUTES:
        start = now.replace(second=0, microsecond=0)
        return _to_ms(start) + 60_000 - 1
    if d == GREGORIAN_HOURS:
        start = now.replace(minute=0, second=0, microsecond=0)
        return _to_ms(start) + 3_600_000 - 1
    if d == GREGORIAN_DAYS:
        start = now.replace(hour=0, minute=0, second=0, microsecond=0)
        return _to_ms(start) + 86_400_000 - 1
    if d == GREGORIAN_WEEKS:
        raise GregorianError("`Duration = GregorianWeeks` not yet supported")
    if d == GREGORIAN_MONTHS:
        start = now.replace(day=1, hour=0, minute=0, second=0, microsecond=0)
        days = calendar.monthrange(now.year, now.month)[1]
        return _to_ms(start + timedelta(days=days)) - 1
    if d == GREGORIAN_YEARS:
        start = now.replace(
            month=1, day=1, hour=0, minute=0, second=0, microsecond=0
        )
        return _to_ms(start.replace(year=start.year + 1)) - 1
    raise GregorianError(
        "behavior DURATION_IS_GREGORIAN is set; but `Duration` is not a valid "
        "gregorian interval"
    )
