"""RX application-layer tests: stats bus, telemetry console, uploader, web
GUI — exercised over real sockets on localhost."""
import http.client
import http.server
import json
import socket
import threading
import time

import numpy as np
import pytest

from wenet_tpu.core import packets as wp
from wenet_tpu.rx import stats as rxstats
from wenet_tpu.rx import telemetry_console, uploader, web


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    p = s.getsockname()[1]
    s.close()
    return p


def test_stats_parser_and_wire_format():
    st = rxstats.FSKDemodStats(averaging_time=5, peak_hold=True,
                               freq=441200000, sample_rate=921416)
    rec = {"EbNodB": 14.5, "ppm": 12, "f1_est": 120000.0, "f2_est": 230000.0,
           "samp_fft": list(np.ones(128))}
    st.update(json.dumps(rec))
    st.update(dict(rec, EbNodB=17.0))
    assert st.snr == 17.0                  # peak hold
    assert st.fest == [120000.0, 230000.0]
    assert len(st.fft_db) == 128
    wire = st.to_wire()
    assert wire["type"] == "MODEM_STATS"
    assert wire["fcentre"] == 441200000 + 175000.0
    # nan scrub path
    st.update('{"EbNodB": nan, "ppm": 0, "f1_est": 1, "f2_est": 2, "samp_fft": [1]}')


def test_receiver_stats_record():
    from wenet_tpu.ops import fsk
    from wenet_tpu.rx.pipeline import Receiver
    cfg = fsk.FSKConfig(Fs=96000, Rs=9600)
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2, cfg.Nbits * 30).astype(np.uint8)
    sig, _ = fsk.fsk_mod_np(cfg, bits, 19200, 9600)
    # stats/GUI consumers opt into the eye-probe carry (cli/rx does when
    # UDP stats are on); the decode-only default is with_eye=False
    rx = Receiver(mode="v2", cfg=cfg, with_eye=True)
    rx.push((0.3 * sig).astype(np.complex64))
    rec = rxstats.receiver_stats_record(rx)
    assert set(rxstats.FSK_STATS_FIELDS) <= set(rec)
    assert abs(rec["f1_est"] - 19200) < cfg.Fs / cfg.Ndft
    assert len(rec["samp_fft"]) == cfg.Ndft // 2

    # eye traces flow end-to-end: IQ -> Receiver -> stats record ->
    # FSKDemodStats wire message -> GUI model (fsk_demod.c:366-377 parity)
    eye = rec["eye_diagram"]
    neyesamp = (2 * cfg.P) // int(np.ceil(2 * cfg.P / 160))
    assert len(eye) == 8 and len(eye[0]) == neyesamp
    assert max(max(r) for r in eye) == 1.0          # normalised to 1
    # alternating tone rows: eye openings differ between rows
    assert np.std(np.asarray(eye)) > 0.01
    acc = rxstats.FSKDemodStats(averaging_time=1.0, sample_rate=cfg.Fs)
    acc.update(rec)
    assert acc.to_wire()["eye_diagram"] == eye
    from wenet_tpu.rx.gui import ModemStatsModel
    m = ModemStatsModel()
    m.update(acc.to_wire() | rec)      # GUI consumes the stats vocabulary
    assert m.eye is not None and m.eye.shape == (8, neyesamp)


def test_telemetry_console_receives_broadcast():
    port = _free_port()
    lines = []
    t = threading.Thread(target=telemetry_console.listen,
                         kwargs=dict(port=port, max_packets=1,
                                     print_fn=lines.append), daemon=True)
    t.start()
    time.sleep(0.3)
    pkt = wp.encode_text_message("console test", 5)
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    for _ in range(5):
        s.sendto(json.dumps({"type": "WENET",
                             "packet": list(bytearray(pkt))}).encode(),
                 ("127.0.0.1", port))
        time.sleep(0.2)
        if lines:
            break
    t.join(timeout=3)
    assert lines and "console test" in lines[0]


def test_uploader_blocks_and_file_watch(tmp_path):
    received = []

    class Sink(http.server.BaseHTTPRequestHandler):
        def do_POST(self):
            n = int(self.headers["Content-Length"])
            received.append(json.loads(self.rfile.read(n)))
            self.send_response(200)
            self.end_headers()

        def log_message(self, *a):
            pass

    httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Sink)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}/api/v0/packets"

    up = uploader.SSDVUploader(
        uploader_callsign="TEST", ssdv_url=url,
        watch_directory=str(tmp_path), watch_time=0.2,
        upload_block_size=4, upload_anyway=0.5)
    # file watcher path: write an SSDV-ish bin file after startup
    time.sleep(0.4)
    with open(tmp_path / "img.bin", "wb") as f:
        f.write(bytes(range(256)) * 6)
    deadline = time.time() + 8
    while time.time() < deadline and up.upload_count < 6:
        time.sleep(0.2)
    up.close()
    httpd.shutdown()
    assert up.upload_count >= 6
    assert received and received[0]["type"] == "packets"
    first = received[0]["packets"][0]
    assert first["receiver"] == "TEST" and first["encoding"] == "base64"


def test_web_server_events_and_image(tmp_path):
    srv = web.WenetWebServer(port=0, udp_port=None,
                             image_dir=str(tmp_path))
    try:
        # index page
        c = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=5)
        c.request("GET", "/")
        r = c.getresponse()
        assert r.status == 200 and b"Wenet Receiver" in r.read()

        # image endpoint
        img = tmp_path / "x.jpg"
        img.write_bytes(b"\xff\xd8fakejpeg\xff\xd9")
        srv.handle_image(str(img))
        c.request("GET", "/latest.jpg")
        r = c.getresponse()
        assert r.status == 200 and r.read().startswith(b"\xff\xd8")

        # SSE stream: subscribe, publish a text packet, expect the event
        ev_conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=5)
        ev_conn.request("GET", "/events")
        resp = ev_conn.getresponse()
        time.sleep(0.2)
        srv.handle_packet(wp.encode_text_message("hello web", 9))
        line = b""
        deadline = time.time() + 5
        while time.time() < deadline:
            chunk = resp.fp.readline()
            if chunk.startswith(b"data:"):
                line = chunk
                break
        d = json.loads(line[5:].strip())
        assert d["type"] == "TEXT" and d["text"] == "hello web"
    finally:
        srv.close()


def test_payload_summary_emit():
    port = _free_port()
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    s.settimeout(3)
    s.bind(("", port))
    gps = {"timestamp": "2026-08-17T01:02:03", "latitude": -34.9,
           "longitude": 138.6, "altitude": 10000.0, "numSV": 9,
           "ground_speed": 42.0, "heading": 90.0}
    web.emit_payload_summary("GROUND", "VK5QI", gps,
                             {"fcentre": 441200500.0, "snr": 15.2}, port)
    d = json.loads(s.recvfrom(65535)[0])
    s.close()
    assert d["type"] == "PAYLOAD_SUMMARY"
    assert d["callsign"] == "VK5QI-Wenet"
    assert d["frequency"] == round(441200500.0 / 1e6, 5)


def test_selftest_passes():
    from wenet_tpu.rx import selftest
    assert selftest.run(verbose=False) == 0


def test_rx_cli_acquire_recovers_offset(tmp_path):
    """cli rx --acquire: a capture mistuned beyond the estimator band is
    probed across the offset grid, mixed, and fully decoded."""
    import glob
    import numpy as np
    from wenet_tpu.cli.rx import main as rx_main
    from wenet_tpu.core import framing, packets
    from wenet_tpu.ops import fsk, ldpc

    cfg = fsk.FSKConfig(Fs=96000, Rs=9600)
    rng = np.random.default_rng(3)
    bits = [rng.integers(0, 2, cfg.Nbits * 8).astype(np.uint8)]
    for i in range(3):
        p = packets.encode_text_message("acq %d" % i, i)
        bits.append(framing.frame_to_bits(
            framing.frame_packet(p, ldpc.encode_bytes, mode="v2"), "v2"))
    bits.append(rng.integers(0, 2, cfg.Nbits * 8).astype(np.uint8))
    stream = np.concatenate(bits)
    stream = np.concatenate(
        [stream, np.zeros((-len(stream)) % cfg.Nbits, np.uint8)])
    sig, _ = fsk.fsk_mod_np(cfg, stream, 2 * cfg.Rs, cfg.Rs)
    noise = rng.normal(0, 0.05, (len(sig), 2)).astype(np.float32)
    iq = (0.3 * sig + noise[:, 0] + 1j * noise[:, 1]).astype(np.complex64)
    n = np.arange(len(iq), dtype=np.float64)
    iq = (iq * np.exp(2j * np.pi * np.mod(n * 30000.0 / cfg.Fs, 1.0))
          ).astype(np.complex64)
    cap = tmp_path / "cap.c64"
    iq.tofile(cap)

    rc = rx_main([str(cap), "--format", "c64", "--fs", "96000", "--rs",
                  "9600", "--no-udp", "--acquire", "1.5",
                  "--image-dir", str(tmp_path / "img"),
                  "--log-dir", str(tmp_path / "logs")])
    assert rc == 0
    logs = glob.glob(str(tmp_path / "logs" / "*text*.log"))
    assert logs, "no text telemetry logged"
    body = open(logs[0]).read()
    assert all(("acq %d" % i) in body for i in range(3)), body
