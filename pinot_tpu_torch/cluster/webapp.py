"""Controller web application (single-file SPA, no build step).

Reference parity: pinot-controller/src/main/resources/app — the React/TS
cluster manager. The TPU-native stance replaces the 500-module React
build with one server-bootstrapped page: the controller renders the
current cluster snapshot INTO the page (so the first paint needs no
round trip and the page is meaningful to curl/tests), and the embedded
vanilla-JS app hydrates from it, then live-refreshes from GET /ui/data
and drives the admin REST (rebalance, periodic tasks, segment delete)
and any broker's /query/sql console.

Views (hash-routed): #/cluster (instances + leadership), #/tables
(list -> per-table detail: segments, assignment, rebalance), #/fleet
(the ForensicsRollup panels: per-table fleet stats, slowest queries,
drift/requantize + batching health per node, top-N hot segments with
device-memory bytes), #/tasks (periodic task status + run), #/query
(SQL console with EXPLAIN toggle against a configurable broker URL,
persisted in localStorage).

Port of ``pinot_tpu/cluster/webapp.py``: for the same snapshot the page
is the reference's, byte for byte outside the script's comments (which
carry no history tags here). The port's ``/ui/data`` has no ``compile``
block, so the page shows none of the compile plane's health.
"""
from __future__ import annotations

import json
from typing import Any, Dict

_PAGE = """<!doctype html>
<html><head><meta charset="utf-8">
<title>pinot-tpu controller</title>
<style>
:root{--fg:#1d2733;--mut:#6b7a90;--line:#d7dee8;--acc:#2458e6;
--bad:#c0392b;--ok:#1e8e3e;--bg:#f6f8fb}
*{box-sizing:border-box}
body{font-family:system-ui,sans-serif;margin:0;color:var(--fg);
background:var(--bg)}
header{display:flex;align-items:center;gap:24px;padding:10px 20px;
background:#fff;border-bottom:1px solid var(--line)}
header h1{font-size:16px;margin:0}
nav a{margin-right:14px;text-decoration:none;color:var(--mut);
font-weight:600;font-size:14px}
nav a.on{color:var(--acc)}
main{padding:20px;max-width:1100px}
table{border-collapse:collapse;background:#fff;width:100%;
margin:10px 0 24px}
td,th{border:1px solid var(--line);padding:6px 10px;font-size:13px;
text-align:left}
th{background:#eef2f8}
.badge{padding:1px 8px;border-radius:9px;font-size:12px;color:#fff}
.live{background:var(--ok)}.dead{background:var(--bad)}
button{background:var(--acc);border:0;color:#fff;border-radius:4px;
padding:5px 12px;font-size:13px;cursor:pointer}
button.sec{background:#fff;color:var(--acc);
border:1px solid var(--acc)}
textarea{width:100%;height:90px;font-family:ui-monospace,monospace;
font-size:13px;padding:8px;border:1px solid var(--line);
border-radius:4px}
input[type=text]{padding:5px 8px;border:1px solid var(--line);
border-radius:4px;font-size:13px;width:320px}
.err{color:var(--bad);white-space:pre-wrap;font-family:monospace}
.mut{color:var(--mut);font-size:12px}
a.tbl{color:var(--acc);cursor:pointer;text-decoration:underline}
</style></head><body>
<header><h1>pinot-tpu controller</h1>
<nav id="nav"></nav>
<span class="mut" id="meta"></span>
<label class="mut" style="margin-left:auto">
<input type="checkbox" id="auto" checked> auto-refresh</label>
</header>
<main id="main"></main>
<script id="bootstrap" type="application/json">__BOOTSTRAP__</script>
<script>
"use strict";
let D = JSON.parse(document.getElementById("bootstrap").textContent);
const esc = (s) => String(s).replace(/[&<>"'\\\\]/g,
  c => ({"&":"&amp;","<":"&lt;",">":"&gt;",'"':"&quot;",
         "'":"&#39;","\\\\":"&#92;"}[c]));
const VIEWS = [["#/cluster","Cluster"],["#/tables","Tables"],
  ["#/fleet","Fleet"],["#/tasks","Tasks"],["#/query","Query console"]];

function nav() {
  const cur = location.hash || "#/cluster";
  document.getElementById("nav").innerHTML = VIEWS.map(([h, t]) =>
    `<a href="${h}" class="${cur.startsWith(h) ? "on" : ""}">${t}</a>`
  ).join("");
  document.getElementById("meta").textContent =
    `routing v${D.version} · leader: ${D.leader || "?"}`;
}

async function refresh() {
  try {
    const r = await fetch("/ui/data");
    if (r.ok) { D = await r.json(); render(); }
  } catch (e) { /* controller restarting: keep the last snapshot */ }
}

function table(headers, rows) {
  return `<table><tr>${headers.map(h => `<th>${h}</th>`).join("")}</tr>`
    + rows.map(r => `<tr>${r.map(c => `<td>${c}</td>`).join("")}</tr>`)
      .join("") + "</table>";
}

function vCluster() {
  const inst = Object.entries(D.instances).map(([id, i]) =>
    [esc(id),
     `<span class="badge ${i.live ? "live" : "dead"}">` +
       `${i.live ? "LIVE" : "DEAD"}</span>`,
     esc((i.tags || []).join(", ")), esc(i.host || "")]);
  const ing = D.ingest || {};
  const ingest = `<p class="mut">realtime ingest: rows ` +
    `${ing.ingest_rows || 0} | freshness ` +
    `${ing.freshness_ms != null ?
        ing.freshness_ms.toFixed(1) + " ms" : "n/a"} | commits ` +
    `${ing.ingest_commits || 0} | commit retries ` +
    `${ing.ingest_commit_retries || 0} | rebalance resets ` +
    `${ing.ingest_rebalance_resets || 0} | upsert replays ` +
    `${ing.ingest_upsert_replays || 0} | orphans cleaned ` +
    `${ing.ingest_orphans_cleaned || 0}</p>`;
  return `<h2>Instances</h2>` +
    table(["id", "state", "tags", "host"], inst) + ingest +
    `<h2>Leadership</h2>` +
    table(["leader", "lease holder", "this instance"],
      [[esc(D.leader || "-"), esc(D.lease_holder || "-"),
        esc(D.instance_id || "-")]]) +
    `<p class="mut">debug surfaces: <a href="/debug">/debug</a> ·
     <a href="/debug/fleet">/debug/fleet</a> ·
     <a href="/debug/incidents">/debug/incidents</a> — per-node
     queries/compile/memory/ledger/slo indexes at each broker and
     server's own <code>/debug</code></p>`;
}

function vTables() {
  const rows = Object.entries(D.tables).map(([t, m]) =>
    [`<a class="tbl" href="#/tables/${encodeURIComponent(t)}">` +
       `${esc(t)}</a>`,
     m.replication, (m.segments || []).length,
     esc(m.tenant || "default")]);
  return "<h2>Tables</h2>" +
    table(["table", "replication", "segments", "tenant"], rows);
}

function vTable(t) {
  const m = D.tables[t];
  if (!m) return `<p class="err">unknown table ${esc(t)}</p>`;
  const segs = (m.segments || []).map(s =>
    [esc(s), esc(((m.assignment || {})[s] || []).join(", ")),
     `<button class="sec" data-act="del" data-t="${esc(t)}"` +
       ` data-s="${esc(s)}">delete</button>`]);
  return `<h2>${esc(t)}</h2>
    <p><button data-act="reb" data-t="${esc(t)}">rebalance</button>
    <span class="mut" id="actmsg">${esc(actMsg[t] || "")}</span></p>
    <h3>Segments</h3>` +
    table(["segment", "servers", ""], segs);
}

function vFleet() {
  // the ForensicsRollup panels (GET /debug/fleet via D.fleet)
  const f = D.fleet || {};
  const r = f.rollup;
  if (!r) return `<h2>Fleet forensics</h2>
    <p class="mut">no rollup yet — run the ForensicsRollup task
    (Tasks view) once brokers/servers have ledgers to pull.</p>`;
  const pull = `<p class="mut">pulls ${f.pulls || 0} ·
    nodes ${r.nodes_polled - r.nodes_skipped}/${r.nodes_polled} ok
    (${(r.skipped_nodes || []).map(esc).join(", ") || "none skipped"}) ·
    ${r.fleet_records || 0} fleet records · ledger ${esc(f.ledger
    || "")}</p>`;
  // fleet SLO view: worst-replica burn per objective —
  // fleet_rollup.slo from the proc-deduped node blocks
  const slo = r.slo || {};
  const sloTbl = (slo.objectives || []).length ? table(
    ["scope", "kind", "objective", "burn fast", "burn slow",
     "budget left", "events", "bad", "state"],
    slo.objectives.map(s => [esc(s.scope), esc(s.kind),
      s.objective != null ? s.objective : "-",
      (s.burn_fast != null ? s.burn_fast : 0) + "x",
      (s.burn_slow != null ? s.burn_slow : 0) + "x",
      ((s.budget_remaining != null ? s.budget_remaining : 1) * 100)
        .toFixed(1) + "%",
      s.events || 0, s.bad || 0,
      (s.alerting ? '<span class="badge dead">ALERTING</span>'
                  : '<span class="badge live">OK</span>') +
      (s.stale ? ' <span class="badge dead">STALE</span>' : "")]))
    : `<p class="mut">${slo.armed ? "no objectives reporting yet"
        : "SLO plane unarmed — no objectives declared on the nodes"
      }</p>`;
  const sloHead = `<h3>SLO error budgets <span class="mut">(worst
    replica · open incidents ${slo.open_incidents || 0} — see
    /debug/incidents on any node)</span></h3>`;
  const tbl = table(["table", "queries", "qps", "p50 ms", "p99 ms",
      "partial", "failovers", "hedges", "batched", "slow", "shed",
      "freshness ms"],
    Object.entries(r.tables || {}).map(([t, s]) =>
      [esc(t), s.queries || 0, s.qps || 0, s.p50_ms || 0,
       s.p99_ms || 0, s.partial || 0, s.failovers || 0, s.hedges || 0,
       s.batched_queries || 0, s.slow || 0,
       (s.shed || 0) + (s.shed_by_tenant &&
         Object.keys(s.shed_by_tenant).length
         ? " (" + Object.entries(s.shed_by_tenant).map(([tn, n]) =>
             esc(tn) + ":" + n).join(", ") + ")" : ""),
       s.freshness_ms != null ? s.freshness_ms : "-"]));
  const slow = table(["qid", "node", "table", "wall ms", "partial",
      "sql"],
    (r.slow_queries || []).map(q => [esc(q.qid || ""),
      esc(q.node || ""), esc(q.table || ""), q.wall_ms,
      q.partial ? "YES" : "no", esc(q.sql || "")]));
  // hottest plan shapes by warmup cost (compiles x median compile ms)
  // — the AOT executable plane's prefetch list
  const shapes = table(["plan shape", "compiles", "median ms",
      "total ms", "warmup cost", "triggers", "sql"],
    (r.plan_shapes || []).map(p => [esc(p.plan_shape || ""),
      p.compiles || 0, p.median_compile_ms || 0,
      p.total_compile_ms || 0, p.warmup_cost || 0,
      esc(JSON.stringify(p.triggers || {})), esc(p.sql || "")]));
  const heat = table(["table", "segment", "touches", "rows scanned",
      "device hit ratio"],
    (r.heat || []).map(h => [esc(h.table), esc(h.segment), h.touches,
      h.rows_scanned,
      h.device_hit_ratio != null ? h.device_hit_ratio : "-"]));
  const nodes = table(["node", "role", "drift det/req/rec",
      "retraces", "batched", "cube hit/miss", "device bytes",
      "tier hot/warm/cold", "promote/demote", "affinity"],
    Object.entries(r.nodes || {}).map(([n, b]) => {
      const c = b.counters || {};
      const mem = ((b.memory || {}).total || {}).bytes || 0;
      const t = b.tier || {};
      const th = t.hot || {}, tw = t.warm || {}, tc = t.cold || {};
      return [esc(n), esc(b.role || ""),
        `${c.selectivity_drift_detected || 0}/` +
          `${c.selectivity_drift_requantized || 0}/` +
          `${c.selectivity_drift_recompiles || 0}`,
        c.plan_cache_retraces || 0, c.batched_dispatches || 0,
        `${c.cube_cache_hits || 0}/${c.cube_cache_misses || 0}`, mem,
        `${th.segments || 0} (${th.bytes || 0}B) / ` +
          `${tw.segments || 0} (${tw.bytes || 0}B) / ` +
          `${tc.segments || 0}` +
          (t.armed ? ` · budget ${t.budget_bytes}B` : ""),
        `${c.tier_promotions || 0}/${c.tier_demotions || 0}`,
        c.tier_affinity_hits || 0];
    }));
  // closed-loop rebalance moves ring (D.rebalance —
  // GET /debug/rebalance): the move audit stream beside the SLO
  // budgets that trigger it
  const rb = D.rebalance || {};
  const moveTbl = (rb.moves || []).length ? table(
    ["phase", "table", "segment", "donor", "receiver", "bytes",
     "reason"],
    rb.moves.map(m => [esc(m.phase || ""), esc(m.table || ""),
      esc(m.segment || ""), esc(m.donor || ""), esc(m.receiver || ""),
      m.bytes || 0, esc(m.reason || "")]))
    : `<p class="mut">no moves yet — the ClosedLoopRebalance task
      plans from the rollup's burn table (frozen while incidents are
      open)</p>`;
  const moveHead = `<h3>Rebalance moves <span class="mut">(passes
    ${rb.passes || 0} · executed ${rb.executed || 0} · aborted
    ${rb.aborted || 0} · resumed ${rb.resumed || 0} · frozen
    ${rb.frozen_passes || 0}${rb.pending ? " · MOVE PENDING" : ""}
    )</span></h3>`;
  // incident autopsy verdicts (fleet_rollup.autopsy —
  // newest rca_verdict briefs in the pulled corpus; on-demand
  // fleet-wide attribution at GET /debug/autopsy)
  const rcaTbl = (r.autopsy || []).length ? table(
    ["ts", "node", "incident", "verdict", "score", "detail"],
    r.autopsy.map(v => [esc(v.ts || ""), esc(v.node || ""),
      esc(v.incident_ref || "—"),
      v.inconclusive ? '<span class="mut">inconclusive</span>'
                     : esc(v.top_cause || ""),
      v.top_score != null ? v.top_score : "",
      esc(v.detail || "")]))
    : `<p class="mut">no verdicts yet — attribution runs
      automatically when an incident fires (cluster/autopsy.py), or
      on demand at <a href="/debug/autopsy">/debug/autopsy</a></p>`;
  const rcaHead = `<h3>Autopsy <span class="mut">(root-cause
    verdicts, newest first)</span></h3>`;
  return `<h2>Fleet forensics</h2>${pull}
    ${sloHead}${sloTbl}
    ${rcaHead}${rcaTbl}
    ${moveHead}${moveTbl}
    <h3>Per-table fleet stats</h3>${tbl}
    <h3>Slowest queries</h3>${slow}
    <h3>Hottest plan shapes (warmup debt)</h3>${shapes}
    <h3>Hot segments</h3>${heat}
    <h3>Drift / batching / device memory / HBM tier per node</h3>${nodes}`;
}

function vTasks() {
  const rows = Object.entries(D.tasks || {}).map(([n, s]) =>
    [esc(n), esc(JSON.stringify(s)),
     `<button class="sec" data-act="task" data-t="${esc(n)}">` +
       "run</button>"]);
  return "<h2>Periodic tasks</h2>" + table(["task", "status", ""], rows);
}

function vQuery() {
  const broker = localStorage.getItem("brokerUrl") || "";
  return `<h2>Query console</h2>
    <p>broker URL: <input type="text" id="broker"
      value="${esc(broker)}" placeholder="http://host:port">
      <label class="mut"><input type="checkbox" id="explain">
      EXPLAIN</label>
      <label class="mut"><input type="checkbox" id="analyze">
      ANALYZE</label></p>
    <textarea id="sql">SELECT 1</textarea>
    <p><button data-act="query">run</button>
    <button class="sec" data-act="forensics">slow queries</button>
    <span class="mut" id="qtime"></span></p>
    <div id="qout"></div><div id="forout"></div>`;
}

async function showForensics() {
  // the broker-side query-forensics ring (GET /debug/queries)
  const broker = document.getElementById("broker").value.trim();
  localStorage.setItem("brokerUrl", broker);
  const out = document.getElementById("forout");
  try {
    const d = await (await fetch(broker + "/debug/queries?n=20")).json();
    if (!d.count) {
      out.innerHTML = `<p class="mut">no slow queries recorded ` +
        `(threshold ${d.slowQueryMs} ms)</p>`;
      return;
    }
    out.innerHTML = `<h3>Slow queries ` +
      `<span class="mut">(threshold ${d.slowQueryMs} ms)</span></h3>` +
      table(["qid", "wall ms", "table", "partial", "failovers",
             "hedges", "sql"],
        d.queries.map(e => [esc(e.qid), e.wall_ms, esc(e.table),
          e.partial ? "YES" : "no", e.failovers || 0, e.hedges || 0,
          esc((e.sql || "").slice(0, 120))]));
  } catch (e) {
    out.innerHTML = `<p class="err">${esc(e)}</p>`;
  }
}

async function runQuery() {
  const broker = document.getElementById("broker").value.trim();
  localStorage.setItem("brokerUrl", broker);
  let sql = document.getElementById("sql").value;
  if (document.getElementById("analyze").checked)
    sql = "EXPLAIN ANALYZE " + sql;
  else if (document.getElementById("explain").checked)
    sql = "EXPLAIN PLAN FOR " + sql;
  const out = document.getElementById("qout");
  const t0 = performance.now();
  try {
    const r = await fetch(broker + "/query/sql", {method: "POST",
      headers: {"Content-Type": "application/json"},
      body: JSON.stringify({sql})});
    const res = await r.json();
    const ms = (performance.now() - t0).toFixed(1);
    // our broker reports errors as HTTP 4xx {"error": str}; keep the
    // reference's exceptions[] shape working too — but a PARTIAL
    // result (allowPartialResults=true) carries both exceptions and
    // surviving rows: render the rows under a warning, not an error
    if (res.error || (res.exceptions && res.exceptions.length
        && !res.partialResult)) {
      out.innerHTML = `<p class="err">${esc(
        res.error || JSON.stringify(res.exceptions))}</p>`;
      document.getElementById("qtime").textContent = "";
      return;
    }
    const rt = res.resultTable || res;
    const cols = (rt.dataSchema && rt.dataSchema.columnNames)
      || rt.columns || [];
    const rows = rt.rows || [];
    const warn = res.partialResult
      ? `<p class="err">PARTIAL RESULT: ${res.numServersResponded}` +
        `/${res.numServersQueried} servers responded — ` +
        `${esc((res.exceptions || []).map(e => e.message).join("; "))}` +
        `</p>`
      : "";
    out.innerHTML = warn + table(cols.map(esc),
      rows.map(row => row.map(c => esc(JSON.stringify(c)))));
    const srv = res.timeUsedMs !== undefined
      ? ` · ${Number(res.timeUsedMs).toFixed(1)} ms server` : "";
    document.getElementById("qtime").textContent =
      `${rows.length} rows · ${ms} ms round trip${srv}`;
  } catch (e) {
    out.innerHTML = `<p class="err">${esc(e)}</p>`;
  }
}

async function post(path) {
  const r = await fetch(path, {method: "POST"});
  return r.ok ? r.json().catch(() => ({})) : {error: r.status};
}
const actMsg = {};  // per-table: survives refresh(), never leaks into
async function rebalance(t) {       // another table's detail view
  const res = await post("/rebalance/" + encodeURIComponent(t));
  actMsg[t] = "rebalance: " + JSON.stringify(res);
  await refresh();
}
async function runTask(n) {
  await post("/periodictask/run/" + encodeURIComponent(n));
  refresh();
}
async function delSeg(t, s) {
  if (!confirm(`delete segment ${s} of ${t}?`)) return;
  await fetch(`/segments/${encodeURIComponent(t)}/` +
    encodeURIComponent(s), {method: "DELETE"});
  refresh();
}

function render() {
  nav();
  const h = location.hash || "#/cluster";
  const main = document.getElementById("main");
  const mt = h.match(/^#\\/tables\\/(.+)$/);
  if (mt) main.innerHTML = vTable(decodeURIComponent(mt[1]));
  else if (h.startsWith("#/tables")) main.innerHTML = vTables();
  else if (h.startsWith("#/fleet")) main.innerHTML = vFleet();
  else if (h.startsWith("#/tasks")) main.innerHTML = vTasks();
  else if (h.startsWith("#/query")) main.innerHTML = vQuery();
  else main.innerHTML = vCluster();
}
// event delegation via data attributes: dataset values arrive
// entity-DECODED as plain strings, so names with quotes/backslashes
// can never become executable script (no inline onclick handlers)
document.addEventListener("click", (ev) => {
  const b = ev.target.closest("button[data-act]");
  if (!b) return;
  const {act, t, s} = b.dataset;
  if (act === "del") delSeg(t, s);
  else if (act === "reb") rebalance(t);
  else if (act === "task") runTask(t);
  else if (act === "query") runQuery();
  else if (act === "forensics") showForensics();
});
window.addEventListener("hashchange", render);
setInterval(() => {
  if (document.getElementById("auto").checked
      && !(location.hash || "").startsWith("#/query")) refresh();
}, 3000);
render();
</script></body></html>"""


def render_app(bootstrap: Dict[str, Any]) -> str:
    """The SPA page with the cluster snapshot inlined (hydration seed —
    first paint and curl/tests see real data with zero extra fetches).
    `</` must not appear un-escaped inside a <script> block."""
    blob = json.dumps(bootstrap).replace("</", "<\\/")
    return _PAGE.replace("__BOOTSTRAP__", blob)
