"""The mean host ms a request's call took to return: the time the server
spends enqueuing its launches."""

import readings


def read(rec):
    return readings.dispatch_ms(rec)
