"""Telemetry visualisation — the counterpart of the reference's plotly notebooks.

The reference inspects episodes through two notebooks
(predictions_visualisation.ipynb, to_be_model_visualisation.ipynb) that read
the ``*-prediction_results.json`` / ``*-initial_values.json`` files the env
dumps and chart essentially every series.  This CLI renders the full coverage
from those files — ours or the reference's, the keys match:

- per-charger SoC with requested-SoC overlays and arrival/departure markers
  (the notebooks' per-vehicle tables, from ``--initial-values``),
- per-charger actions and power values (``Charger_actions``,
  ``Charger_power_values``),
- aggregate powers, battery action/power/SoC, available vs utilized solar,
- the complete penalty breakdown (all 8 sub-penalty series the env records,
  envs/smart_nanogrid_environment.py:246-275) and costs.

Run:  python -m smart_nanogrid_gym_torch.tools.visualize \\
          --results out/RL/single_prediction_files/prediction_results.json \\
          [--initial-values out/.../initial_values.json] [--out day.png]

The PyTorch port keeps this copy of ``smart_nanogrid_gym_tpu/tools/visualize.py``
(numpy and matplotlib only), unchanged apart from this note and the module
path above, so that it imports nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def load_results(path: str) -> dict:
    with open(path) as fp:
        return json.load(fp)


def _series(results: dict, key: str):
    v = results.get(key)
    return None if v is None else np.asarray(v)


def _plot_keyed(ax, results, pairs, title, ylabel=""):
    for key, label in pairs:
        s = _series(results, key)
        if s is not None and s.size:
            ax.plot(s, label=label, lw=1.2)
    ax.legend(fontsize=7)
    ax.set_title(title, fontsize=9)
    ax.set_xlabel("timestep", fontsize=8)
    if ylabel:
        ax.set_ylabel(ylabel, fontsize=8)
    ax.tick_params(labelsize=7)
    ax.grid(True, alpha=0.3)


def plot_results(results: dict, out_path: str, title: str = "",
                 initial_values: dict | None = None) -> str:
    """Render the full 28-series telemetry of one episode to a single PNG."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    soc = _series(results, "SOC")
    T = len(results.get("Total_cost", [])) or (soc.shape[1] if soc is not None else 24)
    N = soc.shape[0] if soc is not None else 0

    fig, axes = plt.subplots(3, 3, figsize=(19, 12), constrained_layout=True)

    # --- (0,0) per-charger SoC + requested-SoC overlays + arrival/departure ---
    ax = axes[0][0]
    colors = plt.cm.tab10.colors
    if soc is not None:
        for c in range(N):
            ax.plot(soc[c, :T], label=f"charger {c}", lw=1.2, color=colors[c % 10])
    if initial_values:
        req = np.asarray(initial_values.get("Requested_SOC", []))
        arr = initial_values.get("Arrivals", [])
        dep = initial_values.get("Departures", [])
        if req.size:
            for c in range(min(N, req.shape[0])):
                nz = req[c, :T] > 0
                if nz.any():
                    ax.plot(np.where(nz, req[c, :T], np.nan), ls="--", lw=0.9,
                            color=colors[c % 10], alpha=0.7)
        for c in range(min(N, len(arr))):
            for a in arr[c]:
                if a < T:
                    ax.axvline(a, color=colors[c % 10], lw=0.5, alpha=0.35)
            for d in dep[c] if c < len(dep) else []:
                if d < T:
                    ax.axvline(d, color=colors[c % 10], lw=0.5, alpha=0.35, ls=":")
    ax.legend(fontsize=7)
    ax.set_title("Vehicle SoC (dashed: requested; |: arrival, ⋮: departure)", fontsize=9)
    ax.set_xlabel("timestep", fontsize=8)
    ax.grid(True, alpha=0.3)

    # --- (0,1) per-charger actions + battery action ---
    ax = axes[0][1]
    acts = _series(results, "Charger_actions")
    if acts is not None and acts.size:
        for c in range(acts.shape[1]):
            ax.step(range(len(acts)), acts[:, c], label=f"charger {c}",
                    lw=1.0, where="post", color=colors[c % 10])
    b_act = _series(results, "Battery_action")
    if b_act is not None and b_act.size:
        ax.step(range(len(b_act)), b_act, label="battery", lw=1.2, where="post",
                color="k", ls="--")
    ax.legend(fontsize=7)
    ax.set_title("Actions", fontsize=9)
    ax.set_xlabel("timestep", fontsize=8)
    ax.grid(True, alpha=0.3)

    # --- (0,2) per-charger power values ---
    ax = axes[0][2]
    powers = _series(results, "Charger_power_values")
    if powers is not None and powers.size:
        for c in range(powers.shape[1]):
            ax.plot(powers[:, c], label=f"charger {c}", lw=1.0, color=colors[c % 10])
    ax.legend(fontsize=7)
    ax.set_title("Per-charger power [kW]", fontsize=9)
    ax.set_xlabel("timestep", fontsize=8)
    ax.grid(True, alpha=0.3)

    # --- (1,0) aggregate powers ---
    _plot_keyed(axes[1][0], results, [
        ("Total_charging_power", "charging"),
        ("Total_discharging_power", "discharging"),
        ("Grid_power", "grid"),
        ("Battery_power_value", "battery"),
        ("Battery_calculated_power_value", "battery (pre-clamp)"),
    ], "Aggregate powers [kW]")

    # --- (1,1) solar: available (2-day trace) vs utilized ---
    ax = axes[1][1]
    avail = _series(results, "Available_solar_energy")
    if avail is not None and avail.size:
        ax.plot(avail.reshape(-1)[:T], label="available", lw=1.2)
    used = _series(results, "Utilized_solar_energy")
    if used is not None and used.size:
        ax.plot(used, label="utilized", lw=1.2)
    ax.legend(fontsize=7)
    ax.set_title("Solar energy [kWh]", fontsize=9)
    ax.set_xlabel("timestep", fontsize=8)
    ax.grid(True, alpha=0.3)

    # --- (1,2) BESS state ---
    ax = axes[1][2]
    bsoc = _series(results, "Battery_state_of_charge")
    if bsoc is not None and bsoc.size:
        ax.plot(bsoc, label="BESS SoC", lw=1.4, color="tab:green")
        init = results.get("Initial_battery_state_of_charge")
        if init is not None:
            ax.axhline(float(np.asarray(init)), color="tab:green", ls=":",
                       lw=0.9, label="initial SoC")
    ax.legend(fontsize=7)
    ax.set_title("Battery state of charge", fontsize=9)
    ax.set_xlabel("timestep", fontsize=8)
    ax.grid(True, alpha=0.3)

    # --- (2,0) vehicle penalty breakdown (incl. telemetry-only series) ---
    _plot_keyed(axes[2][0], results, [
        ("Total_vehicle_penalties", "total vehicle"),
        ("Insufficiently_charged_vehicle_penalties", "insufficient"),
        ("Needlessly_charged_vehicle_penalties", "needless"),
        ("Overcharged_vehicle_penalties", "overcharged"),
        ("Over_discharged_vehicle_penalties", "over-discharged"),
        ("DisCharging_nonexistent_vehicles_penalties", "nonexistent (marker)"),
    ], "Vehicle penalties")

    # --- (2,1) battery/nanogrid penalty breakdown ---
    _plot_keyed(axes[2][1], results, [
        ("Total_battery_penalties", "total battery"),
        ("Battery_SOC_below_DoD_penalties", "DoD"),
        ("Battery_overcharging_penalties", "overcharge"),
        ("Battery_over_discharging_penalties", "over-discharge"),
        ("Low_resource_utilisation_penalties", "low utilisation"),
        ("Total_penalties", "total (weighted)"),
    ], "Battery / nanogrid penalties")

    # --- (2,2) costs ---
    _plot_keyed(axes[2][2], results, [
        ("Total_cost", "total cost"),
        ("Grid_energy_cost", "grid energy cost"),
        ("Grid_energy", "grid energy [kWh]"),
    ], "Costs")

    if title:
        fig.suptitle(title)
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def build_panels(results: dict, initial_values: dict | None = None) -> list[dict]:
    """The 9-panel layout of :func:`plot_results` as plain data — shared by the
    PNG and the interactive HTML renderers."""
    panels: list[dict] = []

    def keyed(title, pairs, step=False):
        series = []
        for key, label in pairs:
            s = _series(results, key)
            if s is not None and s.size:
                series.append({"name": label,
                               "y": np.asarray(s, float).reshape(-1).tolist(),
                               "step": step})
        if series:
            panels.append({"title": title, "series": series, "vlines": []})

    soc = _series(results, "SOC")
    T = len(results.get("Total_cost", [])) or (soc.shape[1] if soc is not None else 24)

    if soc is not None and soc.size:
        series = [{"name": f"charger {c}", "y": soc[c, :T].astype(float).tolist()}
                  for c in range(soc.shape[0])]
        vlines = []
        if initial_values:
            req = np.asarray(initial_values.get("Requested_SOC", []))
            for c in range(min(soc.shape[0], req.shape[0] if req.size else 0)):
                row = np.where(req[c, :T] > 0, req[c, :T], np.nan)
                if np.isfinite(row).any():
                    series.append({"name": f"requested {c}", "dash": True,
                                   "y": [None if not np.isfinite(v) else float(v)
                                         for v in row]})
            for kind, key in (("arrival", "Arrivals"), ("departure", "Departures")):
                for c, times in enumerate(initial_values.get(key, [])):
                    vlines += [{"x": int(t), "kind": kind, "charger": c}
                               for t in times if t < T]
        panels.append({"title": "Vehicle SoC (dashed: requested)",
                       "series": series, "vlines": vlines})

    acts = _series(results, "Charger_actions")
    if acts is not None and acts.size:
        series = [{"name": f"charger {c}", "step": True,
                   "y": acts[:, c].astype(float).tolist()}
                  for c in range(acts.shape[1])]
        b_act = _series(results, "Battery_action")
        if b_act is not None and b_act.size:
            series.append({"name": "battery", "step": True, "dash": True,
                           "y": b_act.astype(float).tolist()})
        panels.append({"title": "Actions", "series": series, "vlines": []})

    powers = _series(results, "Charger_power_values")
    if powers is not None and powers.size:
        panels.append({"title": "Per-charger power [kW]", "vlines": [], "series": [
            {"name": f"charger {c}", "y": powers[:, c].astype(float).tolist()}
            for c in range(powers.shape[1])]})

    keyed("Aggregate powers [kW]", [
        ("Total_charging_power", "charging"),
        ("Total_discharging_power", "discharging"),
        ("Grid_power", "grid"),
        ("Battery_power_value", "battery"),
        ("Battery_calculated_power_value", "battery (pre-clamp)"),
    ])
    avail = _series(results, "Available_solar_energy")
    solar = []
    if avail is not None and avail.size:
        solar.append({"name": "available",
                      "y": avail.reshape(-1)[:T].astype(float).tolist()})
    used = _series(results, "Utilized_solar_energy")
    if used is not None and used.size:
        solar.append({"name": "utilized", "y": used.astype(float).tolist()})
    if solar:
        panels.append({"title": "Solar energy [kWh]", "series": solar, "vlines": []})
    keyed("Battery state of charge", [
        ("Battery_state_of_charge", "BESS SoC"),
    ])
    keyed("Vehicle penalties", [
        ("Total_vehicle_penalties", "total vehicle"),
        ("Insufficiently_charged_vehicle_penalties", "insufficient"),
        ("Needlessly_charged_vehicle_penalties", "needless"),
        ("Overcharged_vehicle_penalties", "overcharged"),
        ("Over_discharged_vehicle_penalties", "over-discharged"),
        ("DisCharging_nonexistent_vehicles_penalties", "nonexistent (marker)"),
    ])
    keyed("Battery / nanogrid penalties", [
        ("Total_battery_penalties", "total battery"),
        ("Battery_SOC_below_DoD_penalties", "DoD"),
        ("Battery_overcharging_penalties", "overcharge"),
        ("Battery_over_discharging_penalties", "over-discharge"),
        ("Low_resource_utilisation_penalties", "low utilisation"),
        ("Total_penalties", "total (weighted)"),
    ])
    keyed("Costs", [
        ("Total_cost", "total cost"),
        ("Grid_energy_cost", "grid energy cost"),
        ("Grid_energy", "grid energy [kWh]"),
    ])
    return panels


_HTML_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>__TITLE__</title>
<style>
 body{font-family:system-ui,sans-serif;background:#fafafa;margin:14px}
 h1{font-size:16px} .grid{display:grid;grid-template-columns:repeat(auto-fill,minmax(430px,1fr));gap:12px}
 .panel{background:#fff;border:1px solid #ddd;border-radius:6px;padding:8px}
 .panel h2{font-size:12px;margin:2px 0 6px}
 .legend{font-size:10px;display:flex;flex-wrap:wrap;gap:6px;margin-top:4px}
 .legend span{cursor:pointer;user-select:none;padding:1px 4px;border-radius:3px}
 .legend .off{opacity:.3;text-decoration:line-through}
 .tip{position:fixed;pointer-events:none;background:#222;color:#fff;font-size:10px;
      padding:4px 6px;border-radius:4px;display:none;white-space:pre;z-index:9}
</style></head><body>
<h1>__TITLE__</h1>
<p style="font-size:11px;color:#555">Interactive telemetry explorer (hover for
values, click legend entries to toggle series) — same 28-series JSON contract
as the reference's plotly notebooks. Self-contained: no network, no plotly.</p>
<div class="grid" id="grid"></div><div class="tip" id="tip"></div>
<script>
const PANELS = __DATA__;
const COLORS = ["#1f77b4","#ff7f0e","#2ca02c","#d62728","#9467bd","#8c564b",
                "#e377c2","#7f7f7f","#bcbd22","#17becf"];
const W=430,H=230,ML=46,MR=8,MT=8,MB=22;
function fin(v){return v!==null&&isFinite(v);}
PANELS.forEach((panel,pi)=>{
  const div=document.createElement("div");div.className="panel";
  div.innerHTML="<h2>"+panel.title+"</h2>";
  const svg=document.createElementNS("http://www.w3.org/2000/svg","svg");
  svg.setAttribute("viewBox",`0 0 ${W} ${H}`);svg.style.width="100%";
  const T=Math.max(...panel.series.map(s=>s.y.length));
  let lo=Infinity,hi=-Infinity;
  panel.series.forEach(s=>s.y.forEach(v=>{if(fin(v)){lo=Math.min(lo,v);hi=Math.max(hi,v);}}));
  if(!isFinite(lo)){lo=0;hi=1;} if(lo===hi){lo-=1;hi+=1;}
  const X=t=>ML+(W-ML-MR)*t/Math.max(T-1,1), Y=v=>MT+(H-MT-MB)*(1-(v-lo)/(hi-lo));
  for(let g=0;g<5;g++){const v=lo+(hi-lo)*g/4,y=Y(v);
    svg.innerHTML+=`<line x1="${ML}" x2="${W-MR}" y1="${y}" y2="${y}" stroke="#eee"/>`+
      `<text x="2" y="${y+3}" font-size="8" fill="#888">${v.toPrecision(3)}</text>`;}
  for(let t=0;t<T;t+=Math.ceil(T/8)){svg.innerHTML+=
      `<text x="${X(t)}" y="${H-6}" font-size="8" fill="#888" text-anchor="middle">${t}</text>`;}
  panel.vlines.forEach(v=>{svg.innerHTML+=
    `<line x1="${X(v.x)}" x2="${X(v.x)}" y1="${MT}" y2="${H-MB}" stroke="${COLORS[v.charger%10]}"`+
    ` stroke-width="0.6" opacity="0.35" ${v.kind==="departure"?'stroke-dasharray="2,2"':""}/>`;});
  panel.series.forEach((s,si)=>{
    let d="",pen=false,prevY=0;
    s.y.forEach((v,t)=>{if(!fin(v)){pen=false;return;}
      const x=X(t),y=Y(v);
      if(s.step&&pen)d+=" L"+x.toFixed(1)+" "+prevY.toFixed(1);
      d+=(pen?" L":" M")+x.toFixed(1)+" "+y.toFixed(1);pen=true;prevY=y;});
    const p=document.createElementNS("http://www.w3.org/2000/svg","path");
    p.setAttribute("d",d);p.setAttribute("fill","none");
    p.setAttribute("stroke",COLORS[si%10]);p.setAttribute("stroke-width","1.3");
    if(s.dash)p.setAttribute("stroke-dasharray","4,3");
    p.dataset.si=si;svg.appendChild(p);});
  div.appendChild(svg);
  const leg=document.createElement("div");leg.className="legend";
  panel.series.forEach((s,si)=>{const e=document.createElement("span");
    e.textContent="— "+s.name;e.style.color=COLORS[si%10];
    e.onclick=()=>{e.classList.toggle("off");
      const path=svg.querySelector(`path[data-si="${si}"]`);
      path.style.display=e.classList.contains("off")?"none":"";};
    leg.appendChild(e);});
  div.appendChild(leg);
  svg.addEventListener("mousemove",ev=>{
    const r=svg.getBoundingClientRect(),px=(ev.clientX-r.left)*W/r.width;
    const ti=Math.max(0,Math.min(T-1,
      Math.round((px-ML)/((W-ML-MR)/Math.max(T-1,1)))));
    const tip=document.getElementById("tip");
    let txt="t = "+ti;
    panel.series.forEach((s,si)=>{
      const off=leg.children[si].classList.contains("off");
      if(!off&&fin(s.y[ti]))txt+="\\n"+s.name+": "+Number(s.y[ti]).toPrecision(5);});
    tip.textContent=txt;tip.style.display="block";
    tip.style.left=(ev.clientX+14)+"px";tip.style.top=(ev.clientY+10)+"px";});
  svg.addEventListener("mouseleave",()=>{document.getElementById("tip").style.display="none";});
  document.getElementById("grid").appendChild(div);});
</script></body></html>
"""


def render_html(results: dict, out_path: str, title: str = "",
                initial_values: dict | None = None) -> str:
    """Interactive single-file HTML telemetry explorer (reference parity with
    the plotly notebooks' per-series interactive subplots — hover readouts and
    per-series toggling — without any plotly/pandas dependency: inline SVG +
    vanilla JS over the same 28-key JSON the notebooks read)."""
    panels = build_panels(results, initial_values)
    html = (_HTML_TEMPLATE
            .replace("__TITLE__", title or "smart-nanogrid episode telemetry")
            .replace("__DATA__", json.dumps(panels)))
    with open(out_path, "w") as fp:
        fp.write(html)
    return out_path


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--results", required=True, help="prediction_results.json path")
    p.add_argument("--initial-values", default=None,
                   help="matching initial_values.json (adds requested-SoC "
                        "overlays + arrival/departure markers)")
    p.add_argument("--out", default="prediction_results.png")
    p.add_argument("--html", default=None,
                   help="also write an interactive self-contained HTML explorer")
    p.add_argument("--title", default="")
    args = p.parse_args(argv)
    iv = load_results(args.initial_values) if args.initial_values else None
    results = load_results(args.results)
    path = plot_results(results, args.out, args.title, initial_values=iv)
    out = {"figure": path}
    if args.html:
        out["html"] = render_html(results, args.html, args.title, initial_values=iv)
    print(json.dumps(out))
    return path


if __name__ == "__main__":
    main()
