"""Embedded single-page viewer UI.

The reference embeds a monitoring SPA under /monitoring (ydb/core/viewer
serves an asset bundle; viewer.cpp routes /viewer/json/* for data). This
is the lean analog: one self-contained HTML page (no external assets, no
build step) that polls the same /viewer/json/* endpoints this node
already serves and renders them as tables. Served at /viewer by
``ydb_tpu_torch.obs.viewer.Viewer``.

The port's own copy of ``ydb_tpu/obs/viewer_html.py``: the page is the
reference's, byte for byte.
"""

PAGE = """<!doctype html>
<html lang="en">
<head>
<meta charset="utf-8">
<title>ydb_tpu viewer</title>
<style>
  :root { color-scheme: light dark; }
  body { font: 13px/1.5 system-ui, sans-serif; margin: 0;
         background: Canvas; color: CanvasText; }
  header { padding: 10px 16px; border-bottom: 1px solid color-mix(
           in srgb, CanvasText 20%, Canvas); display: flex;
           gap: 16px; align-items: baseline; flex-wrap: wrap; }
  header b { font-size: 15px; }
  header .muted, .muted { opacity: .65; }
  nav a { margin-right: 10px; cursor: pointer; text-decoration: none;
          color: LinkText; }
  nav a.on { font-weight: 700; text-decoration: underline; }
  main { padding: 12px 16px; }
  table { border-collapse: collapse; margin: 8px 0 20px; }
  th, td { border: 1px solid color-mix(in srgb, CanvasText 20%, Canvas);
           padding: 3px 9px; text-align: left;
           font-variant-numeric: tabular-nums; }
  th { background: color-mix(in srgb, CanvasText 8%, Canvas); }
  td.num { text-align: right; }
  .status-GOOD { color: green; font-weight: 700; }
  .status-DEGRADED { color: darkorange; font-weight: 700; }
  .status-EMERGENCY { color: crimson; font-weight: 700; }
  select { font: inherit; }
  pre { white-space: pre-wrap; }
</style>
</head>
<body>
<header>
  <b>ydb_tpu</b>
  <span id="summary" class="muted">loading…</span>
  <nav id="nav"></nav>
  <a href="/counters/prometheus">prometheus</a>
</header>
<main id="main">loading…</main>
<script>
"use strict";
const TABS = ["overview", "profiles", "timeline", "tablets",
              "statistics", "resident", "sysviews", "topics",
              "counters"];
const tabOf = h => TABS.includes(h) ? h : "overview";
let tab = tabOf(location.hash.slice(1));
let sysviewName = "";

const get = p => fetch(p).then(r => r.json());
const esc = s => String(s).replace(/[&<>]/g,
  c => ({"&": "&amp;", "<": "&lt;", ">": "&gt;"}[c]));

function renderTable(rows, cols) {
  if (!rows.length) return "<p class=muted>(empty)</p>";
  cols = cols || Object.keys(rows[0]);
  const th = cols.map(c => `<th>${esc(c)}</th>`).join("");
  const trs = rows.map(r => "<tr>" + cols.map(c => {
    const v = r[c];
    const num = typeof v === "number";
    return `<td class="${num ? "num" : ""}">${
      v === null || v === undefined ? "" : esc(v)}</td>`;
  }).join("") + "</tr>").join("");
  return `<table><tr>${th}</tr>${trs}</table>`;
}

function kv(obj) {
  return renderTable(Object.entries(obj).map(
    ([k, v]) => ({key: k, value: typeof v === "object"
                  ? JSON.stringify(v) : v})));
}

const VIEWS = {
  async overview() {
    const [cluster, health, wb] = await Promise.all([
      get("/viewer/json/cluster"), get("/viewer/json/healthcheck"),
      get("/viewer/json/whiteboard")]);
    const issues = (health.issues || []).map(i =>
      typeof i === "string" ? {issue: i} : i);
    return `<h3>health:
        <span class="status-${esc(health.status)}">${
        esc(health.status)}</span></h3>`
      + (issues.length ? renderTable(issues) : "")
      + "<h3>cluster</h3>" + kv(cluster)
      + "<h3>recent queries</h3>"
      + renderTable(wb.recent_queries || [])
      + "<h3>memory</h3>" + kv(wb.memory || {});
  },
  async profiles() {
    const p = await get("/viewer/json/query_profile");
    const top = (p.top || []).map(q => ({
      query: q.sql, class: q.query_class, seconds: q.seconds,
      rows: q.rows, compile_s: q.compile_seconds,
      execute_s: q.execute_seconds, plan_cache: q.plan_cache,
      compile_cache: q.compile_cache,
      compute_s: (q.stages || {}).compute, read_s: (q.stages || {}).read,
    }));
    let spanHtml = "<p class=muted>(no profiled query yet)</p>";
    if (p.last) {
      const rows = [];
      (function walk(nodes, depth) {
        for (const s of nodes || []) {
          rows.push({span: "\\u00a0".repeat(depth * 2) + s.name,
                     seconds: s.seconds,
                     attrs: JSON.stringify(s.attrs)});
          walk(s.children, depth + 1);
        }
      })(p.last.span_tree, 0);
      spanHtml = renderTable(rows, ["span", "seconds", "attrs"]);
    }
    return "<h3>top queries (most expensive retained)</h3>"
      + renderTable(top)
      + "<h3>last query span tree</h3>" + spanHtml;
  },
  async timeline() {
    const t = await get("/viewer/json/timeline");
    const cats = Object.entries(t.categories || {}).map(
      ([k, v]) => Object.assign({category: k}, v));
    const mv = Object.entries(t.movement_bytes || {}).map(
      ([k, v]) => ({counter: k, bytes: v}));
    const note = t.enabled ? "" :
      "<p class=muted>timeline ring is OFF (set YDB_TPU_TIMELINE=1" +
      " to record events; byte counters below are always on)</p>";
    return "<h3>data-movement timeline</h3>" + note
      + kv({enabled: t.enabled, events: t.events,
            recorded: t.recorded, dropped: t.dropped,
            capacity: t.capacity})
      + "<h3>per-category busy time</h3>" + renderTable(cats)
      + "<h3>movement bytes (cumulative)</h3>" + renderTable(mv)
      + "<h3>active queries</h3>"
      + renderTable(t.active_queries || [])
      + `<p><a href="/viewer/json/timeline?trace=1" download=` +
        `"trace.json">download Chrome trace JSON</a> ` +
        `<span class=muted>(open in ui.perfetto.dev)</span></p>`;
  },
  async tablets() {
    const t = await get("/viewer/json/tablets");
    return "<h3>per-tablet counters</h3>" + renderTable(t.tablets || [])
      + "<h3>aggregates by type</h3>"
      + renderTable(Object.entries(t.aggregates || {}).map(
          ([k, v]) => Object.assign({type: k}, v)));
  },
  async statistics() {
    const s = await get("/viewer/json/statistics");
    return "<h3>column statistics (NDV / null fractions)</h3>"
      + renderTable(s.columns || [])
      + "<h3>scan pruning (cumulative per shard)</h3>"
      + renderTable(s.pruning || []);
  },
  async resident() {
    const r = await get("/viewer/json/resident");
    return "<h3>HBM-resident column tier (totals)</h3>"
      + kv(r.total || {})
      + "<h3>per shard</h3>" + renderTable(r.shards || []);
  },
  async sysviews() {
    const names = await get("/viewer/json/sysview");
    if (!sysviewName) sysviewName = names[0] || "";
    const opts = names.map(n => `<option ${
      n === sysviewName ? "selected" : ""}>${esc(n)}</option>`);
    let body = "<p class=muted>(pick a view)</p>";
    if (sysviewName) {
      const rows = await get(
        "/viewer/json/sysview?name=" + encodeURIComponent(sysviewName));
      body = renderTable(rows);
    }
    return `<h3>system views</h3>
      <select onchange="sysviewName=this.value;render()">${
      opts.join("")}</select>` + body;
  },
  async topics() {
    return "<h3>topic partitions</h3>"
      + renderTable(await get("/viewer/json/topics"));
  },
  async counters() {
    const c = await get("/counters");
    const flat = [];
    (function walk(prefix, node) {
      for (const [k, v] of Object.entries(node)) {
        const p = prefix ? prefix + "." + k : k;
        if (v && typeof v === "object" && !Array.isArray(v))
          walk(p, v);
        else flat.push({counter: p, value: Array.isArray(v)
                        ? JSON.stringify(v) : v});
      }
    })("", c);
    return "<h3>counters</h3>" + renderTable(flat);
  },
};

async function render() {
  document.getElementById("nav").innerHTML = TABS.map(t =>
    `<a class="${t === tab ? "on" : ""}" href="#${t}">${t}</a>`
  ).join("");
  try {
    document.getElementById("main").innerHTML = await VIEWS[tab]();
  } catch (e) {
    document.getElementById("main").innerHTML =
      "<pre>" + esc(e) + "</pre>";
  }
  try {
    const c = await get("/viewer/json/cluster");
    document.getElementById("summary").textContent =
      `node ${c.node_id} · ${c.tables.length} tables · ` +
      `${c.topics.length} topics · up ${c.uptime_seconds}s`;
  } catch (e) { /* header stays */ }
}
window.addEventListener("hashchange", () => {
  tab = tabOf(location.hash.slice(1));
  render();
});
render();
setInterval(render, 15000);
</script>
</body>
</html>
"""
