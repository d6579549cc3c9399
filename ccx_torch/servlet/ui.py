"""Operator dashboard.

Parity: the reference serves ``cruise-control-ui`` (a Vue SPA, separate
repo) from its web root (SURVEY.md M5). ccx ships a single-file dashboard —
no build step, stdlib-served — that drives the same REST surface the SPA
uses: cluster summary + per-broker/per-host load (``kafka_cluster_state``,
``load``), monitor windows + executor progress (``state?substates=...``),
partition top-N (``partition_load``), the anomaly-detector / self-healing
panel, the user-task audit trail (``user_tasks``), the review board
(two-step verification), on-demand proposals, and the operator verbs the
SPA exposes (rebalance dryrun/execute, add/remove/demote broker,
fix-offline-replicas, pause/resume sampling, stop execution) — every async
verb long-polled via 202 + User-Task-ID like the SPA's task polling.
"""

PAGE = """<!DOCTYPE html>
<html lang="en"><head><meta charset="utf-8"/>
<title>ccx — cluster dashboard</title>
<style>
 body { font-family: system-ui, sans-serif; margin: 2rem; color: #1a1a22; }
 h1 { font-size: 1.3rem; } h2 { font-size: 1.05rem; margin-top: 1.6rem; }
 table { border-collapse: collapse; margin-top: .5rem; }
 td, th { padding: .25rem .7rem; border-bottom: 1px solid #e3e3ea;
          text-align: right; font-variant-numeric: tabular-nums; }
 th { text-align: left; } td:first-child { text-align: left; }
 .bar { display:inline-block; height: .65rem; background:#5b7fff;
        border-radius:2px; vertical-align: middle; }
 .dead { color: #c0392b; font-weight: 600; }
 .ok { color: #1e8e3e; } .muted { color:#777; font-size:.85rem; }
 .warn { color: #b7791f; }
 pre { background:#f6f6f9; padding: .7rem; border-radius:6px;
       max-width: 72rem; overflow-x: auto; }
 button { padding: .35rem .9rem; border-radius: 6px; border: 1px solid #aab;
          background: #eef; cursor: pointer; margin-right:.4rem; }
 button:disabled { opacity:.5 }
 input, select { padding:.25rem .4rem; border:1px solid #aab;
                 border-radius:4px; width: 7rem; }
 .row { margin:.35rem 0; }
 #actionout { margin-top:.5rem; }
</style></head><body>
<h1>ccx — cluster dashboard</h1>
<div class="muted" id="meta">loading…</div>
<h2>Cluster</h2><div id="summary"></div>
<h2>Monitor</h2><div id="monitor"></div>
<h2>Broker load
 <label class="muted"><input type="checkbox" id="byhost"
  style="width:auto" onchange="refresh()"/> group by host</label>
</h2><div id="load"></div>
<h2>Executor</h2><div id="executor"></div>
<h2>Proposals
 <button id="proposebtn" onclick="computeProposals()">Compute proposals</button>
 <button onclick="verb('rebalance', {dryrun: 'true'})">Rebalance (dryrun)</button>
 <button class="dead" onclick="confirm('Execute a real rebalance?') &&
   verb('rebalance', {dryrun: 'false'})">Rebalance (execute)</button>
</h2>
<div id="proposals" class="muted">not computed yet</div>
<h2>Admin actions</h2>
<div class="row">
 broker id(s): <input id="brokerids" placeholder="e.g. 3 or 3,4"/>
 <button onclick="brokerVerb('add_broker')">add</button>
 <button onclick="brokerVerb('remove_broker')">remove</button>
 <button onclick="brokerVerb('demote_broker')">demote</button>
</div>
<div class="row">
 <button onclick="confirm('Execute fix-offline-replicas?') &&
   verb('fix_offline_replicas', {dryrun: 'false'})">fix offline replicas</button>
 <button onclick="verb('pause_sampling', {reason: 'dashboard'})">pause sampling</button>
 <button onclick="verb('resume_sampling', {reason: 'dashboard'})">resume sampling</button>
 <button onclick="verb('stop_proposal_execution', {})">stop execution</button>
</div>
<div id="actionout" class="muted"></div>
<h2>Partition load (top 15)
 <select id="resource" style="width:auto" onchange="refresh()">
  <option>CPU</option><option>NW_IN</option><option>NW_OUT</option>
  <option>DISK</option></select>
</h2><div id="partitions"></div>
<h2>Anomaly detector / self-healing</h2><div id="anomaly"></div>
<h2>Review board</h2><div id="review" class="muted"></div>
<h2>User tasks</h2><div id="tasks"></div>
<h2>Service state</h2><pre id="state"></pre>
<script>
const J = (u) => fetch(u).then(r => r.json());

async function pollTask(resp, url, method) {
  // async verbs return 202 + User-Task-ID; replay the id until COMPLETED.
  // The replay must reuse the original METHOD — operator verbs are
  // POST-only and the server 405s a GET before the task-id branch.
  if (resp.status !== 202) return resp.json();
  const id = resp.headers.get('User-Task-ID');
  for (;;) {
    await new Promise(r => setTimeout(r, 1500));
    const again = await fetch(url, {method: method || 'GET',
                                    headers: {'User-Task-ID': id}});
    if (again.status !== 202) return again.json();
  }
}

async function verb(endpoint, params) {
  const el = document.getElementById('actionout');
  const q = new URLSearchParams(params).toString();
  const url = '/kafkacruisecontrol/' + endpoint + (q ? '?' + q : '');
  el.textContent = endpoint + ' …';
  try {
    const r = await fetch(url, {method: 'POST'});
    const j = await pollTask(r, url, 'POST');
    if (j.RequestInfo && j.RequestInfo.Id !== undefined) {
      el.innerHTML = endpoint + ': parked for two-step review, id <b>' +
        j.RequestInfo.Id + '</b> — approve below, then run';
    } else if (j.errorMessage) {
      el.innerHTML = '<span class="dead">' + endpoint + ': ' +
        j.errorMessage + '</span>';
    } else {
      const s = j.summary || j;
      el.innerHTML = endpoint + ': ok' +
        (s.numReplicaMovements !== undefined ?
         ' — ' + s.numReplicaMovements + ' replica / ' +
         s.numLeadershipMovements + ' leadership movements, verified ' +
         s.verified : '');
    }
  } catch (e) { el.textContent = endpoint + ' error: ' + e; }
  refresh();
}

function brokerVerb(endpoint) {
  const ids = document.getElementById('brokerids').value.trim();
  if (!ids) { alert('enter broker id(s)'); return; }
  const params = {brokerid: ids, dryrun: 'false', reason: 'dashboard'};
  if (confirm(endpoint + ' ' + ids + '?')) verb(endpoint, params);
}

async function review(id, approve) {
  const url = '/kafkacruisecontrol/review?' + new URLSearchParams(
    approve ? {approve: id} : {discard: id});
  await fetch(url, {method: 'POST'});
  refresh();
}

async function computeProposals() {
  const btn = document.getElementById('proposebtn');
  const el = document.getElementById('proposals');
  btn.disabled = true;
  el.textContent = 'computing…';
  try {
    const url = '/kafkacruisecontrol/proposals';
    const r = await fetch(url);
    const j = await pollTask(r, url);
    const s = j.summary || j;
    const goals = (s.goalSummary || []).map(g =>
      `<tr><td>${g.goal}</td><td>${g.hard ? 'hard' : 'soft'}</td>
       <td>${g.violationsBefore}</td><td>${g.violationsAfter}</td>
       <td>${g.costBefore.toFixed(3)}</td><td>${g.costAfter.toFixed(3)}</td></tr>`
    ).join('');
    el.innerHTML =
      `<div>replica movements: <b>${s.numReplicaMovements}</b>,
        leadership movements: <b>${s.numLeadershipMovements}</b>,
        verified: <b class="${s.verified ? 'ok' : 'dead'}">${s.verified}</b>
        ${s.onDemandBalancednessScoreBefore !== undefined ?
          `, balancedness ${s.onDemandBalancednessScoreBefore.toFixed(1)}
           → ${s.onDemandBalancednessScoreAfter.toFixed(1)}` : ''}</div>
       <table><tr><th>Goal</th><th></th><th>viol before</th><th>viol after</th>
       <th>cost before</th><th>cost after</th></tr>${goals}</table>`;
  } catch (e) { el.textContent = 'error: ' + e; }
  btn.disabled = false;
}

function renderMonitor(ms) {
  if (!ms) return '<span class="muted">monitor state unavailable</span>';
  const cls = ms.state === 'RUNNING' || ms.state === 'SAMPLING' ? 'ok' : 'warn';
  return `<table><tr><th>State</th><th>Valid windows</th>
    <th>Valid partitions</th><th>Samples</th><th>Generation</th>
    <th>Trained</th></tr>
    <tr><td class="${cls}">${ms.state}</td><td>${ms.numValidWindows}</td>
    <td>${(100 * ms.validPartitionsRatio).toFixed(1)}%</td>
    <td>${ms.numTotalSamples}</td>
    <td class="muted">${ms.modelGeneration}</td>
    <td>${ms.trained}</td></tr></table>`;
}

function renderExecutor(ex) {
  if (!ex) return '<span class="muted">executor state unavailable</span>';
  let html = `<div class="${ex.state === 'NO_TASK_IN_PROGRESS' ? 'muted' : 'warn'}">
    state: <b>${ex.state}</b></div>`;
  if (ex.taskCounts) {
    const rows = Object.entries(ex.taskCounts).map(([k, v]) =>
      `<tr><td>${k}</td><td>${JSON.stringify(v)}</td></tr>`).join('');
    const pct = ex.totalDataToMoveMb ?
      100 * ex.finishedDataMovementMb / ex.totalDataToMoveMb : 0;
    html += `<div>data moved: ${(ex.finishedDataMovementMb || 0).toFixed(0)} /
      ${(ex.totalDataToMoveMb || 0).toFixed(0)} MB
      <span class="bar" style="width:${1.2 * pct}px"></span></div>
      <table><tr><th>Phase</th><th>Counts</th></tr>${rows}</table>`;
  }
  return html;
}

function renderAnomaly(ad) {
  if (!ad) return '<span class="muted">detector not running</span>';
  const sh = Object.entries(ad.selfHealingEnabled || {}).map(([k, v]) =>
    `<td class="${v ? 'ok' : 'muted'}">${k}: ${v ? 'on' : 'off'}</td>`).join('');
  const recent = (ad.recentAnomalies || []).slice(-8).reverse().map(a => {
    const an = a.anomaly || a;
    return `<tr><td>${an.type || ''}</td>
     <td>${an.description || JSON.stringify(an)}</td>
     <td>${a.action || ''}</td></tr>`;
  }).join('');
  return `<table><tr>${sh}</tr></table>
    <div class="muted">self-healing runs started: ${ad.numSelfHealingStarted},
      pending checks: ${ad.pendingChecks}</div>
    <table><tr><th>Type</th><th>Anomaly</th><th>Action</th></tr>
    ${recent || '<tr><td colspan=3 class="muted">none</td></tr>'}</table>`;
}

function renderTasks(tj) {
  const rows = (tj.userTasks || []).slice(0, 12).map(t =>
    `<tr><td class="muted">${(t.UserTaskId || '').slice(0, 8)}</td>
     <td>${t.Endpoint}</td>
     <td class="${t.Status === 'Completed' ? 'ok' :
                  t.Status === 'CompletedWithError' ? 'dead' : 'warn'}">
       ${t.Status}</td>
     <td>${new Date(t.StartMs).toLocaleTimeString()}</td>
     <td class="muted">${(t.Progress && t.Progress.length) ?
       t.Progress[t.Progress.length - 1].step || '' : ''}</td></tr>`).join('');
  return `<table><tr><th>Task</th><th>Endpoint</th><th>Status</th>
    <th>Started</th><th>Last step</th></tr>
    ${rows || '<tr><td colspan=5 class="muted">none</td></tr>'}</table>`;
}

function renderReview(rb) {
  const rows = (rb.RequestInfo || []).map(r =>
    `<tr><td>${r.Id}</td><td>${r.EndPoint}</td><td>${r.Status}</td>
     <td class="muted">${r.Reason || ''}</td>
     <td>${r.Status === 'PENDING_REVIEW' ?
       `<button onclick="review(${r.Id}, true)">approve</button>
        <button onclick="review(${r.Id}, false)">discard</button>` :
       r.Status === 'APPROVED' ?
       `<button onclick="verb('${r.EndPoint}', {review_id: ${r.Id}, dryrun: 'false'})">run</button>`
       : ''}
     </td></tr>`).join('');
  return rows ?
    `<table><tr><th>Id</th><th>Endpoint</th><th>Status</th><th>Reason</th>
     <th></th></tr>${rows}</table>` :
    'no pending reviews (two-step verification may be disabled)';
}

function renderLoad(ld, byHost) {
  let rows = ld.brokers;
  if (byHost) {
    const hosts = {};
    for (const b of rows) {
      const h = hosts[b.Host] = hosts[b.Host] || {Broker: b.Host, Rack: b.Rack,
        Host: '', BrokerState: 'ALIVE', Replicas: 0, Leaders: 0, CpuPct: 0,
        NwInRate: 0, NwOutRate: 0, DiskMB: 0, n: 0};
      h.n += 1; h.Replicas += b.Replicas; h.Leaders += b.Leaders;
      // percent-of-broker-capacity is not additive — averaged at render
      h.CpuPct += b.CpuPct; h.NwInRate += b.NwInRate;
      h.NwOutRate += b.NwOutRate; h.DiskMB += b.DiskMB;
      if (b.BrokerState !== 'ALIVE') h.BrokerState = b.BrokerState;
    }
    rows = Object.values(hosts);
    for (const h of rows) h.CpuPct /= h.n;
  }
  const maxDisk = Math.max(1, ...rows.map(b => b.DiskMB));
  return '<table><tr><th>' + (byHost ? 'Host' : 'Broker') +
    '</th><th>Rack</th>' + (byHost ? '<th>Brokers</th>' : '<th>Host</th>') +
    '<th>State</th>' +
    '<th>Replicas</th><th>Leaders</th><th>CPU%</th><th>NwIn</th>' +
    '<th>NwOut</th><th>Disk MB</th><th></th></tr>' +
    rows.map(b =>
      `<tr><td>${b.Broker}</td><td>${b.Rack}</td>
       <td>${byHost ? b.n : (b.Host || '')}</td>
       <td class="${b.BrokerState === 'ALIVE' ? 'ok' : 'dead'}">${b.BrokerState}</td>
       <td>${b.Replicas}</td><td>${b.Leaders}</td>
       <td>${b.CpuPct.toFixed(1)}</td><td>${b.NwInRate.toFixed(0)}</td>
       <td>${b.NwOutRate.toFixed(0)}</td><td>${b.DiskMB.toFixed(0)}</td>
       <td><span class="bar" style="width:${120 * b.DiskMB / maxDisk}px"></span></td>
       </tr>`).join('') + '</table>';
}

function renderPartitions(pl) {
  const rows = (pl.records || []).slice(0, 15).map(p =>
    `<tr><td>${p.topic}</td><td>${p.partition}</td><td>${p.leader}</td>
     <td>${(p.cpu ?? 0).toFixed(3)}</td><td>${(p.networkInbound ?? 0).toFixed(1)}</td>
     <td>${(p.networkOutbound ?? 0).toFixed(1)}</td><td>${(p.disk ?? 0).toFixed(1)}</td>
     </tr>`).join('');
  return `<table><tr><th>Topic</th><th>Partition</th><th>Leader</th>
    <th>CPU</th><th>NwIn</th><th>NwOut</th><th>Disk</th></tr>
    ${rows || '<tr><td colspan=7 class="muted">none</td></tr>'}</table>`;
}

async function refresh() {
  try {
    const res = document.getElementById('resource').value;
    const [st, ks, ld, tj, pl, rb] = await Promise.all([
      J('/kafkacruisecontrol/state?substates=monitor,executor,anomaly_detector'),
      J('/kafkacruisecontrol/kafka_cluster_state'),
      J('/kafkacruisecontrol/load'),
      J('/kafkacruisecontrol/user_tasks'),
      J('/kafkacruisecontrol/partition_load?max_load_entries=15&resource=' + res)
        .catch(() => ({})),
      J('/kafkacruisecontrol/review_board').catch(() => ({})),
    ]);
    const s = ks.KafkaBrokerState.Summary;
    document.getElementById('meta').textContent =
      'refreshed ' + new Date().toLocaleTimeString();
    document.getElementById('summary').innerHTML =
      `<table><tr><th>Brokers</th><th>Hosts</th><th>Alive</th><th>Topics</th>
       <th>Partitions</th><th>Replicas</th><th>URP</th></tr>
       <tr><td>${s.Brokers}</td><td>${s.Hosts ?? s.Brokers}</td>
       <td class="${s.AliveBrokers < s.Brokers ?
       'dead' : 'ok'}">${s.AliveBrokers}</td><td>${s.Topics}</td>
       <td>${s.Partitions}</td><td>${s.Replicas}</td>
       <td class="${s.UnderReplicatedPartitions ? 'dead' : 'ok'}">
       ${s.UnderReplicatedPartitions}</td></tr></table>`;
    document.getElementById('monitor').innerHTML =
      renderMonitor(st.MonitorState);
    document.getElementById('load').innerHTML =
      renderLoad(ld, document.getElementById('byhost').checked);
    document.getElementById('executor').innerHTML =
      renderExecutor(st.ExecutorState);
    document.getElementById('partitions').innerHTML = renderPartitions(pl);
    document.getElementById('anomaly').innerHTML =
      renderAnomaly(st.AnomalyDetectorState);
    document.getElementById('review').innerHTML = renderReview(rb);
    document.getElementById('tasks').innerHTML = renderTasks(tj);
    document.getElementById('state').textContent = JSON.stringify(st, null, 2);
  } catch (e) {
    document.getElementById('meta').textContent = 'error: ' + e;
  }
}
refresh(); setInterval(refresh, 5000);
</script></body></html>
"""
