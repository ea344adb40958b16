"""UI server: live dashboard + static report rendering.

Counterpart of ``deeplearning4j_tpu/ui/server.py``, copied; ``/metrics``
serves the port's monitoring registry.

Reference analog: org.deeplearning4j.ui.api.UIServer (Play/Vert.x web
dashboard with loss charts and per-layer parameter/update histograms).
Dependency-free: "/" serves a vanilla-JS page that polls the "/data" JSON
endpoint every couple of seconds and redraws loss curves plus per-layer
weight/update histogram time series (latest distribution as bars, history
as a heatmap) on canvases — live while training runs, the
attach-storage-then-browse workflow (UIServer.getInstance().attach(...)).
"/report" keeps the static inline-SVG snapshot; "/metrics" exposes the
process-wide monitoring registry in Prometheus text format (same body the
serving servers expose — one scrape config covers training and serving).
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional, Tuple
from urllib.parse import parse_qs, urlparse

from deeplearning4j_tpu_torch.ui.storage import NON_SCALAR_KEYS, StatsStorage


def _svg_line_chart(series: List[Tuple[float, float]], title: str,
                    width: int = 640, height: int = 240) -> str:
    if not series:
        return f"<p>{title}: no data</p>"
    xs = [p[0] for p in series]
    ys = [p[1] for p in series]
    x0, x1 = min(xs), max(xs)
    y0, y1 = min(ys), max(ys)
    if y1 == y0:
        y1 = y0 + 1
    pad = 30
    W, H = width - 2 * pad, height - 2 * pad

    def px(x):
        return pad + (x - x0) / (x1 - x0 or 1) * W

    def py(y):
        return pad + (1 - (y - y0) / (y1 - y0)) * H

    pts = " ".join(f"{px(x):.1f},{py(y):.1f}" for x, y in series)
    return (
        f'<h3>{title}</h3>'
        f'<svg width="{width}" height="{height}" '
        f'style="background:#fafafa;border:1px solid #ddd">'
        f'<polyline fill="none" stroke="#1f77b4" stroke-width="1.5" points="{pts}"/>'
        f'<text x="{pad}" y="{pad - 8}" font-size="11">max {y1:.5g}</text>'
        f'<text x="{pad}" y="{height - 8}" font-size="11">min {y0:.5g}</text>'
        f"</svg>"
    )


def render_report(storage: StatsStorage, session_id: Optional[str] = None) -> str:
    """Full HTML dashboard for one (or every) session."""
    sessions = ([session_id] if session_id else storage.session_ids())
    parts = ["<html><head><title>deeplearning4j_tpu training UI</title></head>"
             "<body><h1>Training dashboard</h1>"]
    for sid in sessions:
        parts.append(f"<h2>session: {sid}</h2>")
        recs = storage.records(sid)
        keys = sorted({k for r in recs for k, v in r.items()
                       if isinstance(v, (int, float))
                       and k not in NON_SCALAR_KEYS})
        for k in keys:
            parts.append(_svg_line_chart(storage.scalars(k, sid), k))
        parts.append(f"<p>{len(recs)} records</p>")
    parts.append("</body></html>")
    return "".join(parts)


def _finite(v):
    return isinstance(v, (int, float)) and -float("inf") < v < float("inf")


def collect_data(storages: List[StatsStorage], max_points: int = 400,
                 max_hist: int = 80) -> dict:
    """The /data JSON payload: scalar series + per-layer histogram series.

    Non-finite scalars are dropped: json.dumps would emit bare NaN, which
    JSON.parse rejects — one diverged step must not freeze the dashboard.
    Series are built in ONE pass over the records (storage.scalars would
    re-read a FileStatsStorage once per key on this 2s polling path)."""
    sessions: dict = {}
    for storage in storages:
        for sid in storage.session_ids():
            recs = storage.records(sid)
            series: dict = {}
            for r in recs:
                for k, v in r.items():
                    if k not in NON_SCALAR_KEYS and _finite(v):
                        series.setdefault(k, []).append(
                            (r["iteration"], v))
            series = {k: sorted(pts)[-max_points:]
                      for k, pts in sorted(series.items())}
            hist_recs = [r for r in recs if "histograms" in r][-max_hist:]
            hists: dict = {}
            for r in hist_recs:
                for layer, entry in r["histograms"].items():
                    slot = hists.setdefault(layer, {"iters": [], "w": [],
                                                    "u": []})
                    slot["iters"].append(r["iteration"])
                    slot["w"].append(entry.get("w"))
                    slot["u"].append(entry.get("u"))
            sessions[sid] = {"series": series, "histograms": hists,
                             "records": len(recs)}
    return {"sessions": sessions}


_DASHBOARD_HTML = """<!doctype html>
<html><head><title>deeplearning4j_tpu training UI</title><style>
body{font-family:sans-serif;margin:16px;background:#fff}
h1{font-size:20px} h2{font-size:16px;margin:18px 0 4px} h3{font-size:13px;margin:8px 0 2px}
canvas{background:#fafafa;border:1px solid #ddd;margin-right:8px}
.row{display:flex;flex-wrap:wrap;align-items:flex-start}
#status{color:#888;font-size:12px}
</style></head><body>
<h1>Training dashboard <span id="status"></span></h1>
<div id="root"></div>
<script>
function line(cv, pts, color) {
  const c = cv.getContext('2d'); c.clearRect(0,0,cv.width,cv.height);
  if (!pts.length) return;
  const xs = pts.map(p=>p[0]), ys = pts.map(p=>p[1]);
  const x0=Math.min(...xs), x1=Math.max(...xs)||1;
  const y0=Math.min(...ys), y1=Math.max(...ys);
  const P=26, W=cv.width-2*P, H=cv.height-2*P;
  c.strokeStyle=color; c.beginPath();
  pts.forEach((p,i)=>{
    const x=P+(p[0]-x0)/((x1-x0)||1)*W, y=P+(1-(p[1]-y0)/((y1-y0)||1))*H;
    i?c.lineTo(x,y):c.moveTo(x,y);});
  c.stroke();
  c.fillStyle='#444'; c.font='10px sans-serif';
  c.fillText('max '+y1.toPrecision(4), P, 12);
  c.fillText('min '+y0.toPrecision(4), P, cv.height-4);
}
function bars(cv, h) {
  const c=cv.getContext('2d'); c.clearRect(0,0,cv.width,cv.height);
  if (!h) return;
  const n=h.counts.length, m=Math.max(...h.counts)||1, W=cv.width/n;
  c.fillStyle='#1f77b4';
  h.counts.forEach((v,i)=>{const bh=v/m*(cv.height-14);
    c.fillRect(i*W, cv.height-bh, W-1, bh);});
  c.fillStyle='#444'; c.font='10px sans-serif';
  c.fillText(h.min.toPrecision(3), 2, 10);
  c.fillText(h.max.toPrecision(3), cv.width-44, 10);
}
function heat(cv, snaps) {
  const c=cv.getContext('2d'); c.clearRect(0,0,cv.width,cv.height);
  const hs=snaps.filter(x=>x);
  if (!hs.length) return;
  const rows=hs[0].counts.length, W=cv.width/hs.length, H=cv.height/rows;
  hs.forEach((h,t)=>{const m=Math.max(...h.counts)||1;
    h.counts.forEach((v,b)=>{
      const a=v/m; c.fillStyle='rgba(31,119,180,'+a.toFixed(3)+')';
      c.fillRect(t*W,(rows-1-b)*H,Math.ceil(W),Math.ceil(H));});});
}
let built={};
function build(root,data){
  for (const [sid,s] of Object.entries(data.sessions)){
    let div=built[sid];
    if(!div){
      div=document.createElement('div'); built[sid]=div; root.appendChild(div);
      div.innerHTML='<h2>session: '+sid+'</h2>';
      div.charts={};
    }
    for (const [k,pts] of Object.entries(s.series)){
      let cv=div.charts[k];
      if(!cv){
        const h=document.createElement('h3'); h.textContent=k; div.appendChild(h);
        cv=document.createElement('canvas'); cv.width=560; cv.height=170;
        div.appendChild(cv); div.charts[k]=cv;
      }
      line(cv, pts, '#1f77b4');
    }
    for (const [layer,hh] of Object.entries(s.histograms)){
      for (const kind of ['w','u']){
        if (!hh[kind].some(x=>x)) continue;
        const key='hist_'+layer+'_'+kind;
        let row=div.charts[key];
        if(!row){
          const h=document.createElement('h3');
          h.textContent=layer+(kind==='w'?' weights':' updates')+
            ' (latest | history)';
          div.appendChild(h);
          row=document.createElement('div'); row.className='row';
          const b=document.createElement('canvas'); b.width=280; b.height=120;
          const m=document.createElement('canvas'); m.width=280; m.height=120;
          row.appendChild(b); row.appendChild(m); div.appendChild(row);
          row.bars=b; row.heat=m; div.charts[key]=row;
        }
        bars(row.bars, hh[kind][hh[kind].length-1]);
        heat(row.heat, hh[kind]);
      }
    }
  }
}
async function tick(){
  try{
    const r=await fetch('/data'); const data=await r.json();
    build(document.getElementById('root'), data);
    document.getElementById('status').textContent=
      'live, updated '+new Date().toLocaleTimeString();
  }catch(e){
    document.getElementById('status').textContent='poll failed: '+e;
  }
}
tick(); setInterval(tick, 2000);
</script></body></html>
"""


class UIServer:
    """Minimal dashboard server (UIServer.getInstance().attach(storage))."""

    def __init__(self, port: int = 0, host: str = "127.0.0.1"):
        self._storages: List[StatsStorage] = []
        self._host = host
        self._port = port
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    def attach(self, storage: StatsStorage) -> "UIServer":
        self._storages.append(storage)
        return self

    @property
    def port(self) -> int:
        return self._httpd.server_address[1] if self._httpd else self._port

    def start(self) -> "UIServer":
        storages = self._storages

        class Handler(BaseHTTPRequestHandler):
            def _send(self, data: bytes, ctype: str):
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):  # noqa: N802
                path = urlparse(self.path).path
                if path in ("/", "/index.html"):
                    self._send(_DASHBOARD_HTML.encode(),
                               "text/html; charset=utf-8")
                elif path == "/data":
                    q = parse_qs(urlparse(self.path).query)

                    def qint(name, default, lo=1, hi=100000):
                        try:
                            return min(max(int(q.get(name, [default])[0]),
                                           lo), hi)
                        except ValueError:
                            return default
                    payload = collect_data(storages,
                                           max_points=qint("points", 400),
                                           max_hist=qint("hist", 80))
                    self._send(json.dumps(payload).encode(),
                               "application/json")
                elif path == "/report":
                    body = "".join(render_report(s) for s in storages) or (
                        "<html><body>no storage attached</body></html>")
                    self._send(body.encode(), "text/html; charset=utf-8")
                elif path == "/metrics":
                    from deeplearning4j_tpu_torch import monitoring

                    self._send(monitoring.metrics_text().encode(),
                               "text/plain; version=0.0.4; charset=utf-8")
                else:
                    self.send_response(404)
                    self.end_headers()

            def log_message(self, *args):
                pass

        self._httpd = ThreadingHTTPServer((self._host, self._port), Handler)
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self):
        if self._httpd:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
