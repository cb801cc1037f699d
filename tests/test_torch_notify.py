"""The port's completion notifications (``utils/notify.py``), against a
webhook served on the loopback interface: the same variable as
torbi_tpu's, a message on success and on failure, and nothing raised when
the webhook is unset or dead."""
import json
import threading
from http.server import BaseHTTPRequestHandler, HTTPServer

import pytest

from torbi_tpu.utils import notify as jax_notify
from torbi_tpu_torch.utils import notify


@pytest.fixture
def webhook(monkeypatch):
    received = []

    class Handler(BaseHTTPRequestHandler):
        def do_POST(self):
            length = int(self.headers['Content-Length'])
            received.append(json.loads(self.rfile.read(length)))
            self.send_response(200)
            self.end_headers()

        def log_message(self, *args):
            pass

    server = HTTPServer(('127.0.0.1', 0), Handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    monkeypatch.setenv(
        notify.ENV_VAR, f'http://127.0.0.1:{server.server_port}/')
    yield received
    server.shutdown()


def test_same_variable_as_jax():
    assert notify.ENV_VAR == jax_notify.ENV_VAR == 'TORBI_TPU_NOTIFY_URL'


def test_unconfigured_is_noop(monkeypatch):
    monkeypatch.delenv(notify.ENV_VAR, raising=False)
    assert notify.send('hello') is False


def test_notify_on_finish_success(webhook):
    @notify.notify_on_finish('unit-job')
    def job():
        return 42

    assert job() == 42
    assert len(webhook) == 1
    assert 'torbi_tpu_torch: unit-job finished' in webhook[0]['text']


def test_notify_on_finish_failure(webhook):
    @notify.notify_on_finish('doomed-job')
    def job():
        raise RuntimeError('boom')

    with pytest.raises(RuntimeError):
        job()
    assert len(webhook) == 1
    assert 'FAILED' in webhook[0]['text'] and 'boom' in webhook[0]['text']


def test_survives_dead_webhook(monkeypatch):
    monkeypatch.setenv(notify.ENV_VAR, 'http://127.0.0.1:9/')
    assert notify.send('hello', timeout=1) is False
