"""Web GUI + chase-car integrations (rx/wenetserver.py equivalent).

The reference uses Flask+SocketIO; this build is stdlib-only: http.server
with a Server-Sent-Events stream replaces socket.io, serving the same event
vocabulary (image / gps / text / orientation / modem_stats / uploader
events: wenetserver.py:93-120, 244-310).  Side integrations kept:

  * UDP 7890 listener thread feeding the event bus (wenetserver.py:315-342)
  * Horus UDP "PAYLOAD_SUMMARY" broadcast for chase cars (:188-242)
  * SondeHub-Amateur position upload (:125-184) — direct API PUT batching
    (the `sondehub` package is not required); disabled unless a station
    callsign is set and the process has egress
"""
from __future__ import annotations

import http.server
import json
import logging
import os
import queue as _queue
import socket
import threading
import time

from ..core import packets as wp

logger = logging.getLogger("wenet_tpu.rx.web")

INDEX_HTML = """<!DOCTYPE html>
<html><head><title>Wenet RX</title><style>
body{font-family:sans-serif;margin:1em;background:#111;color:#eee}
#img{max-width:100%%}.stat{display:inline-block;margin-right:2em}
pre{background:#222;padding:.5em;overflow-x:auto}
</style></head><body>
<h2>Wenet Receiver</h2>
<div><span class=stat>SNR: <b id=snr>-</b> dB</span>
<span class=stat>ppm: <b id=ppm>-</b></span>
<span class=stat>Position: <b id=pos>-</b></span>
<span class=stat>Alt: <b id=alt>-</b> m</span></div>
<p><img id=img src="latest.jpg" onerror="this.style.display='none'"></p>
<h3>Spectrum</h3><canvas id=spec width=640 height=120
 style="background:#000;width:100%%"></canvas>
<h3>Telemetry</h3><pre id=log></pre>
<script>
function drawSpec(db) {
  const cv = document.getElementById('spec'), cx = cv.getContext('2d');
  cx.clearRect(0,0,cv.width,cv.height);
  if (!db || !db.length) return;
  const mn = Math.min(...db), mx = Math.max(...db) + 1e-6;
  cx.strokeStyle = '#4cf'; cx.beginPath();
  db.forEach((v,i) => {
    const x = i/(db.length-1)*cv.width;
    const y = cv.height - (v-mn)/(mx-mn)*cv.height;
    i ? cx.lineTo(x,y) : cx.moveTo(x,y);
  });
  cx.stroke();
}
const es = new EventSource('events');
es.onmessage = (e) => {
  const d = JSON.parse(e.data);
  if (d.type === 'MODEM_STATS') {
    document.getElementById('snr').textContent = d.snr.toFixed(1);
    document.getElementById('ppm').textContent = d.ppm.toFixed(0);
    drawSpec(d.fft_db);
  } else if (d.type === 'IMAGE') {
    const im = document.getElementById('img');
    im.style.display=''; im.src = 'latest.jpg?t=' + Date.now();
  } else if (d.type === 'GPS') {
    document.getElementById('pos').textContent =
      d.latitude.toFixed(5) + ', ' + d.longitude.toFixed(5);
    document.getElementById('alt').textContent = d.altitude.toFixed(0);
  } else if (d.type === 'TEXT') {
    const el = document.getElementById('log');
    el.textContent = (d.text + '\\n' + el.textContent).slice(0, 4000);
  }
};
</script></body></html>"""


class SondeHubAmateurUploader:
    """Minimal direct SondeHub-Amateur API batcher
    (PUT /amateur/telemetry)."""

    API_URL = "https://api.v2.sondehub.org/amateur/telemetry"

    def __init__(self, station_callsign: str, upload_rate: float = 30,
                 url: str | None = None):
        self.station = station_callsign
        self.url = url or self.API_URL
        self.rate = upload_rate
        self._batch = []
        self._lock = threading.Lock()
        self._running = True
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def add_telemetry(self, payload_callsign, timestamp, lat, lon, alt,
                      **kwargs):
        rec = {
            "software_name": "wenet_tpu",
            "software_version": "0.1.0",
            "uploader_callsign": self.station,
            "time_received": timestamp,
            "payload_callsign": payload_callsign,
            "datetime": timestamp,
            "lat": lat, "lon": lon, "alt": alt,
        }
        extra = kwargs.pop("extra_fields", {})
        rec.update(kwargs)
        rec.update(extra)
        with self._lock:
            self._batch.append(rec)

    def _loop(self):
        import requests
        while self._running:
            time.sleep(self.rate)
            with self._lock:
                batch, self._batch = self._batch, []
            if not batch:
                continue
            try:
                requests.put(self.url, json=batch, timeout=20)
            except Exception as e:
                logger.error("SondeHub upload failed: %s", e)

    def close(self):
        self._running = False


def emit_payload_summary(station, callsign, gps_data, modem_stats,
                         udp_port: int = 55673):
    """Horus UDP PAYLOAD_SUMMARY broadcast (wenetserver.py:188-242)."""
    short_time = gps_data["timestamp"].split("T")[1] + "Z"
    packet = {
        "type": "PAYLOAD_SUMMARY",
        "station": station,
        "callsign": callsign + "-Wenet",
        "latitude": round(gps_data["latitude"], 6),
        "longitude": round(gps_data["longitude"], 6),
        "altitude": round(gps_data["altitude"], 1),
        "sats": gps_data["numSV"],
        "speed": round(gps_data["ground_speed"], 1),
        "heading": round(gps_data["heading"], 1),
        "time": short_time,
        "frequency": round(modem_stats.get("fcentre", 0) / 1e6, 5),
        "snr": round(modem_stats.get("snr", -999.0), 1),
        "comment": "Wenet",
    }
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    s.settimeout(1)
    s.setsockopt(socket.SOL_SOCKET, socket.SO_BROADCAST, 1)
    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    raw = json.dumps(packet).encode("ascii")
    try:
        s.sendto(raw, ("<broadcast>", udp_port))
    except socket.error:
        s.sendto(raw, ("127.0.0.1", udp_port))
    s.close()


class WenetWebServer:
    """Event-bus web GUI: serves the live page, latest image, and an SSE
    event stream; ingests events from the UDP 7890 bus or direct calls."""

    def __init__(self, host: str = "127.0.0.1", port: int = 5003,
                 image_dir: str = "./rx_images", my_callsign: str = "N0CALL",
                 udp_port: int | None = wp.WENET_IMAGE_UDP_PORT,
                 horus_udp_port: int = 0, sondehub=None):
        self.image_dir = image_dir
        self.my_callsign = my_callsign
        self.horus_udp_port = horus_udp_port
        self.sondehub = sondehub
        self.latest_image = None
        self.current_callsign = None
        self.current_modem_stats = {}
        self._subscribers = []
        self._sub_lock = threading.Lock()
        self._running = True

        handler = self._make_handler()
        self.httpd = http.server.ThreadingHTTPServer((host, port), handler)
        self.port = self.httpd.server_address[1]
        self._http_thread = threading.Thread(
            target=self.httpd.serve_forever, daemon=True)
        self._http_thread.start()

        self._udp_thread = None
        if udp_port is not None:
            self._udp_port = udp_port
            self._udp_thread = threading.Thread(
                target=self._udp_loop, daemon=True)
            self._udp_thread.start()

    # ------------------------------------------------------------ events

    def publish(self, event: dict):
        with self._sub_lock:
            subs = list(self._subscribers)
        for q in subs:
            try:
                q.put_nowait(event)
            except _queue.Full:
                pass

    def handle_image(self, filename: str, metadata=None):
        self.latest_image = filename
        self.publish({"type": "IMAGE", "filename": os.path.basename(filename),
                      "metadata": metadata})

    def handle_packet(self, payload: bytes):
        """Route a raw telemetry payload (same dispatch as wenetserver's
        socket events)."""
        ptype = wp.decode_packet_type(payload)
        if ptype == wp.PacketType.TEXT_MESSAGE:
            d = wp.decode_text_message(payload)
            if d.get("error") == "None":
                self.publish({"type": "TEXT", "id": d["id"], "text": d["text"]})
        elif ptype == wp.PacketType.GPS_TELEMETRY:
            d = wp.gps_telemetry_decoder(payload)
            if d.get("error") == "None":
                self.publish(dict(d, type="GPS"))
                self._handle_gps(d)
        elif ptype == wp.PacketType.ORIENTATION_TELEMETRY:
            d = wp.orientation_telemetry_decoder(payload)
            if d.get("error") == "None":
                self.publish(dict(d, type="ORIENTATION"))
        elif ptype == wp.PacketType.IMAGE_TELEMETRY:
            d = wp.image_telemetry_decoder(payload)
            if d.get("error") == "None":
                self.current_callsign = d["callsign"]
                self.publish(dict(d, type="IMAGE_TELEMETRY"))

    def _handle_gps(self, gps):
        """SondeHub + Horus emit, gated exactly like wenetserver.py:125-145."""
        if self.current_callsign is None or not self.current_modem_stats:
            return
        if gps["gpsFix"] != 3:
            return
        if self.sondehub:
            extra = {"ascent_rate": round(gps["ascent_rate"], 1),
                     "speed": round(gps["ground_speed"], 1)}
            self.sondehub.add_telemetry(
                self.current_callsign + "-Wenet", gps["timestamp"] + "Z",
                round(gps["latitude"], 6), round(gps["longitude"], 6),
                round(gps["altitude"], 1), sats=gps["numSV"],
                heading=round(gps["heading"], 1), extra_fields=extra,
                modulation="Wenet",
                frequency=round(self.current_modem_stats.get("fcentre", 0) / 1e6, 5),
                snr=round(self.current_modem_stats.get("snr", -999), 1))
        if self.horus_udp_port > 0:
            try:
                emit_payload_summary(self.my_callsign, self.current_callsign,
                                     gps, self.current_modem_stats,
                                     self.horus_udp_port)
            except Exception as e:
                logger.error("Error sending Payload Summary: %s", e)

    # --------------------------------------------------------- UDP ingest

    def _udp_loop(self):
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
        except OSError:
            pass
        s.settimeout(1)
        s.bind(("", self._udp_port))
        while self._running:
            try:
                data, _ = s.recvfrom(65535)
            except socket.timeout:
                continue
            except OSError:
                break
            try:
                d = json.loads(data.decode())
            except ValueError:
                continue
            if d.get("type") == "MODEM_STATS":
                self.current_modem_stats = d
                self.publish(d)
            elif d.get("type") == "UPLOADER_STATS":
                self.publish(d)
            elif d.get("type") == "WENET":
                self.handle_packet(bytes(bytearray(d["packet"])))
            elif "filename" in d:
                self.handle_image(d["filename"], d.get("metadata"))
        s.close()

    # -------------------------------------------------------------- HTTP

    def _make_handler(self):
        server = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                logger.debug(fmt, *args)

            def do_GET(self):
                path = self.path.split("?")[0]
                if path == "/":
                    body = INDEX_HTML.encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "text/html")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif path == "/latest.jpg":
                    if server.latest_image and os.path.exists(server.latest_image):
                        with open(server.latest_image, "rb") as f:
                            body = f.read()
                        self.send_response(200)
                        self.send_header("Content-Type", "image/jpeg")
                        self.send_header("Content-Length", str(len(body)))
                        self.end_headers()
                        self.wfile.write(body)
                    else:
                        self.send_error(404)
                elif path == "/events":
                    self.send_response(200)
                    self.send_header("Content-Type", "text/event-stream")
                    self.send_header("Cache-Control", "no-cache")
                    self.end_headers()
                    q = _queue.Queue(256)
                    with server._sub_lock:
                        server._subscribers.append(q)
                    try:
                        while server._running:
                            try:
                                ev = q.get(timeout=5)
                                self.wfile.write(
                                    b"data: " + json.dumps(ev).encode() + b"\n\n")
                                self.wfile.flush()
                            except _queue.Empty:
                                self.wfile.write(b": keepalive\n\n")
                                self.wfile.flush()
                    except (BrokenPipeError, ConnectionResetError):
                        pass
                    finally:
                        with server._sub_lock:
                            if q in server._subscribers:
                                server._subscribers.remove(q)
                else:
                    self.send_error(404)

        return Handler

    def close(self):
        self._running = False
        self.httpd.shutdown()
