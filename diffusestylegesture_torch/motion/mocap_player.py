"""Self-contained browser mocap player.

Port of `diffusestylegesture_tpu/motion/mocap_player.py` (the port's own copy;
the page is the JAX package's, character for character). The reference ships
a vendored three.js notebook player (`pymo/mocapplayer/playBuffer.html`, fed
a `data.js` buffer by `viz_tools.nb_play_mocap`, `viz_tools.py:190-231`);
this is one dependency-free HTML file with a canvas-2D player (orbit drag,
wheel zoom, play / pause, scrubbing, speed) that reads the same `data.js`
contract, a CSV `dataBuffer` of `<joint>_{X,Y,Z}position` columns and a
`start(dataBuffer, metadata, cameraZ, scale, frameTime)` call, as
:func:`~diffusestylegesture_torch.motion.viz.mocapplayer_buffer` builds it.
Bones are drawn from the parent map.

Usage::

    from diffusestylegesture_torch.motion import pipeline as MP
    from diffusestylegesture_torch.motion.mocap_player import write_mocap_player_html

    pos = MP.MocapParameterizer("position").transform(track)
    write_mocap_player_html(pos, "clip.html", frame_time=1/20)
"""
from __future__ import annotations

import json
from typing import Optional

import numpy as np

from .pipeline import ChannelData
from .viz import mocapplayer_buffer

# The player page. Two placeholders: __DATA_JS__ (the reference-contract
# data.js text: dataBuffer/metadata globals + the start(...) call) and
# __SKELETON_JS__ (a {joint: parent|null} map enabling bone rendering).
_PLAYER_HTML = """<!DOCTYPE html>
<html>
<head>
<meta charset="utf-8">
<title>mocap player</title>
<style>
  html, body { margin: 0; height: 100%; background: #101418; color: #cfd8e3;
               font: 13px system-ui, sans-serif; }
  #stage { display: block; width: 100%; height: calc(100% - 44px);
           cursor: grab; }
  #bar { height: 44px; display: flex; align-items: center; gap: 10px;
         padding: 0 12px; box-sizing: border-box; background: #1a2027; }
  #bar button { width: 64px; }
  #seek { flex: 1; }
  #hud { position: fixed; top: 8px; left: 12px; opacity: 0.7; }
</style>
</head>
<body>
<canvas id="stage"></canvas>
<div id="bar">
  <button id="play">Pause</button>
  <input id="seek" type="range" min="0" max="0" step="1" value="0">
  <select id="speed">
    <option value="0.25">0.25x</option><option value="0.5">0.5x</option>
    <option value="1" selected>1x</option><option value="2">2x</option>
  </select>
  <span id="frameno">0</span>
</div>
<div id="hud">drag: orbit &middot; wheel: zoom</div>
<script>
"use strict";
var skeletonParents = __SKELETON_JS__;

// ---- player state (filled by start()) ----
var P = {
  frames: [],        // [T][J][3] float
  joints: [],        // joint names, column order
  bones: [],         // [childIdx, parentIdx]
  frameTime: 1 / 30,
  scale: 1,
  t: 0,              // playback clock in frames (float)
  playing: true,
  speed: 1,
  yaw: 0.6, pitch: 0.25, dist: 500,
  center: [0, 0, 0],
};

function parseBuffer(csv) {
  var lines = csv.split("\\n").filter(function (l) { return l.trim(); });
  var header = lines[0].split(",");
  // group <joint>_{X,Y,Z}position triplets in column order
  var jointCols = {}, order = [];
  header.forEach(function (h, i) {
    var m = h.match(/^(.*)_([XYZ])position$/);
    if (!m) return;
    if (!(m[1] in jointCols)) { jointCols[m[1]] = {}; order.push(m[1]); }
    jointCols[m[1]][m[2]] = i;
  });
  P.joints = order;
  P.frames = lines.slice(1).map(function (line) {
    var v = line.split(",").map(Number);
    return order.map(function (j) {
      var c = jointCols[j];
      return [v[c.X], v[c.Y], v[c.Z]];
    });
  });
  var index = {};
  order.forEach(function (j, i) { index[j] = i; });
  P.bones = [];
  order.forEach(function (j, i) {
    var p = skeletonParents[j];
    if (p !== null && p !== undefined && p in index)
      P.bones.push([i, index[p]]);
  });
}

function computeCenter() {
  // mean position over a subsample of frames keeps the subject framed
  var acc = [0, 0, 0], n = 0;
  for (var f = 0; f < P.frames.length; f += Math.max(1, P.frames.length >> 5))
    P.frames[f].forEach(function (p) {
      acc[0] += p[0]; acc[1] += p[1]; acc[2] += p[2]; n++;
    });
  P.center = acc.map(function (a) { return a / Math.max(n, 1); });
}

// perspective projection of a world point through the orbit camera
function project(p, w, h) {
  var x = (p[0] - P.center[0]) * P.scale;
  var y = (p[1] - P.center[1]) * P.scale;
  var z = (p[2] - P.center[2]) * P.scale;
  var cy = Math.cos(P.yaw), sy = Math.sin(P.yaw);
  var x1 = cy * x + sy * z, z1 = -sy * x + cy * z;
  var cp = Math.cos(P.pitch), sp = Math.sin(P.pitch);
  var y2 = cp * y - sp * z1, z2 = sp * y + cp * z1;
  var zc = z2 + P.dist;                     // camera looks down -z
  if (zc < 1) zc = 1;
  var f = 0.9 * Math.min(w, h);
  return [w / 2 + f * x1 / zc, h / 2 - f * y2 / zc, zc];
}

var canvas = document.getElementById("stage");
var ctx = canvas.getContext("2d");

function draw() {
  var w = canvas.clientWidth, h = canvas.clientHeight;
  if (canvas.width !== w || canvas.height !== h) {
    canvas.width = w; canvas.height = h;
  }
  ctx.clearRect(0, 0, w, h);
  if (!P.frames.length) return;
  var fi = Math.min(P.frames.length - 1, Math.floor(P.t));
  var pts = P.frames[fi].map(function (p) { return project(p, w, h); });
  ctx.strokeStyle = "#7fd4a8"; ctx.lineWidth = 2;
  P.bones.forEach(function (b) {
    ctx.beginPath();
    ctx.moveTo(pts[b[0]][0], pts[b[0]][1]);
    ctx.lineTo(pts[b[1]][0], pts[b[1]][1]);
    ctx.stroke();
  });
  ctx.fillStyle = "#e8b84b";
  pts.forEach(function (q) {
    ctx.beginPath();
    ctx.arc(q[0], q[1], Math.max(1.5, 140 / q[2]), 0, 2 * Math.PI);
    ctx.fill();
  });
  document.getElementById("frameno").textContent =
    fi + " / " + (P.frames.length - 1);
  var seek = document.getElementById("seek");
  if (document.activeElement !== seek) seek.value = fi;
}

var last = null;
function tick(ts) {
  if (last !== null && P.playing)
    P.t = (P.t + P.speed * (ts - last) / 1000 / P.frameTime) %
          Math.max(P.frames.length, 1);
  last = ts;
  draw();
  requestAnimationFrame(tick);
}

// ---- controls ----
var dragging = false, lx = 0, ly = 0;
canvas.addEventListener("mousedown", function (e) {
  dragging = true; lx = e.clientX; ly = e.clientY;
});
window.addEventListener("mouseup", function () { dragging = false; });
window.addEventListener("mousemove", function (e) {
  if (!dragging) return;
  P.yaw += (e.clientX - lx) * 0.008;
  P.pitch = Math.max(-1.4, Math.min(1.4, P.pitch + (e.clientY - ly) * 0.008));
  lx = e.clientX; ly = e.clientY;
});
canvas.addEventListener("wheel", function (e) {
  e.preventDefault();
  P.dist = Math.max(20, P.dist * Math.exp(e.deltaY * 0.001));
}, { passive: false });
document.getElementById("play").addEventListener("click", function () {
  P.playing = !P.playing;
  this.textContent = P.playing ? "Pause" : "Play";
});
document.getElementById("seek").addEventListener("input", function () {
  P.t = Number(this.value); P.playing = false;
  document.getElementById("play").textContent = "Play";
});
document.getElementById("speed").addEventListener("change", function () {
  P.speed = Number(this.value);
});

// ---- reference data.js contract entry point ----
function start(dataBuffer, metadata, cameraZ, scale, frameTime) {
  P.frameTime = frameTime > 0 ? frameTime : 1 / 30;
  P.scale = scale > 0 ? scale : 1;
  P.dist = cameraZ > 0 ? cameraZ : 500;
  parseBuffer(dataBuffer);
  computeCenter();
  var seek = document.getElementById("seek");
  seek.max = Math.max(P.frames.length - 1, 0);
  window.__mocap_loaded = {
    frames: P.frames.length, joints: P.joints.length, bones: P.bones.length
  };
  requestAnimationFrame(tick);
}

__DATA_JS__
</script>
</body>
</html>
"""


def render_player_html(data_js: str, skeleton_parents: Optional[dict] = None) -> str:
    """Splice a reference-contract ``data.js`` buffer (and an optional
    ``{joint: parent}`` map for bone rendering) into the standalone player
    page. ``data_js`` is any text ending in a
    ``start(dataBuffer, metadata, cz, scale, frameTime)`` call — exactly
    what the vendored player loads from disk (`viz_tools.py:226-227`)."""
    return (_PLAYER_HTML
            .replace("__SKELETON_JS__", json.dumps(skeleton_parents or {}))
            .replace("__DATA_JS__", data_js))


def write_mocap_player_html(track: ChannelData, out_path: str,
                            meta: Optional[np.ndarray] = None,
                            frame_time: float = 1 / 30, scale: float = 1,
                            camera_z: float = 500) -> str:
    """``nb_play_mocap(mocap, "pos")`` equivalent (`viz_tools.py:190-234`)
    without the notebook/iframe machinery: write ONE self-contained HTML
    file playing a position-parameterized track. Returns ``out_path``.

    The reference writes the buffer into the vendored player's directory
    and returns an IPython iframe pointing at it; here the buffer and the
    player travel together, so the artifact can be committed, attached, or
    served from anywhere (the demo pipeline drops one next to each BVH)."""
    data_js = mocapplayer_buffer(track, meta=meta, frame_time=frame_time,
                                 scale=scale, camera_z=camera_z)
    html = render_player_html(data_js, dict(track.parents))
    with open(out_path, "w") as f:
        f.write(html)
    return out_path
