"""Completion notifications for long-running jobs.

The port's own copy of ``torbi_tpu/utils/notify.py``: set
``TORBI_TPU_NOTIFY_URL`` (the JAX package's variable, so one setting serves
both packages) to any HTTP endpoint (a Slack webhook, an ntfy.sh topic,
...), and every ``@notify_on_finish``-wrapped job POSTs a short JSON
message when it finishes and when it fails. Unset, notifications do
nothing. Sending never raises.
"""
import functools
import json
import os
import time
import urllib.request

ENV_VAR = 'TORBI_TPU_NOTIFY_URL'


def send(message, timeout=10):
    """POST a message to the configured webhook; silently no-op when
    unconfigured, never raises (a dead webhook must not kill a day-long
    job at the finish line)."""
    url = os.environ.get(ENV_VAR)
    if not url:
        return False
    try:
        payload = json.dumps({'text': message}).encode()
        request = urllib.request.Request(
            url, data=payload,
            headers={'Content-Type': 'application/json'})
        urllib.request.urlopen(request, timeout=timeout)
        return True
    except Exception:
        return False


def notify_on_finish(description):
    """Decorator: notify when the wrapped job completes or raises"""
    def decorator(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            start = time.time()
            try:
                result = fn(*args, **kwargs)
            except Exception as error:
                send(f'torbi_tpu_torch: {description} FAILED after '
                     f'{time.time() - start:.0f}s: '
                     f'{type(error).__name__}: {error}')
                raise
            send(f'torbi_tpu_torch: {description} finished in '
                 f'{time.time() - start:.0f}s')
            return result
        return wrapped
    return decorator
