"""The in-browser graph editor page (served at /editor) and the scene
hierarchy page (served at /hierarchy).

Counterpart of stable_renderer_tpu/editor_page.py, the same pages. A
dependency-free stand-in for the reference's embedded ComfyUI graph editor
(reference: comfyUI/web/ frontend served by server.py:114-791 and embedded in
the PySide6 editor via QWebEngineView, ui/components/pipeline_editor.py:12-14):
a single-file HTML/JS canvas where nodes from /object_info are placed, wired,
and submitted as the same UI-format workflow JSON the loader consumes
(workflow/loader.py); execution progress + latent previews stream back over
/events (SSE).
"""

EDITOR_HTML = r"""<!doctype html>
<html><head><title>stable_renderer_tpu_torch graph editor</title><style>
body{background:#14161a;color:#ccc;font-family:system-ui,sans-serif;margin:0;overflow:hidden}
#bar{padding:8px;background:#1d2127;border-bottom:1px solid #333;display:flex;gap:8px;align-items:center}
#bar select,#bar button,#bar span{font-size:13px}
button{background:#2d3340;color:#ddd;border:1px solid #555;border-radius:4px;padding:4px 12px;cursor:pointer}
button:hover{background:#3a4252}
#canvas{position:relative;width:100vw;height:calc(100vh - 46px)}
svg{position:absolute;inset:0;pointer-events:none;width:100%;height:100%}
.node{position:absolute;min-width:170px;background:#23272f;border:1px solid #4a5160;border-radius:6px;
 box-shadow:0 3px 10px #0006;user-select:none}
.node h4{margin:0;padding:5px 8px;background:#303744;border-radius:6px 6px 0 0;font-size:12px;cursor:move}
.port{width:10px;height:10px;border-radius:50%;background:#888;display:inline-block;cursor:crosshair;margin:2px}
.port.out{background:#7aa2f7}.port.in{background:#9ece6a}.port.sel{outline:2px solid #ff9e64}
.row{display:flex;justify-content:space-between;align-items:center;padding:1px 4px;font-size:11px}
.node input,.node select{width:90px;background:#161a20;color:#ccc;border:1px solid #444;font-size:11px}
#status{margin-left:auto;font-size:12px;color:#9ece6a}
#preview{position:fixed;right:12px;bottom:12px;max-width:220px;border:1px solid #444;display:none}
progress{width:140px}
.del{float:right;color:#f66;cursor:pointer;padding:0 4px}
.group{position:absolute;border:1px solid #5a6b4a;background:#9ece6a14;border-radius:6px;z-index:0}
.group h5{margin:0;padding:2px 8px;font-size:11px;color:#9ece6a;cursor:move;user-select:none}
.group .rsz{position:absolute;right:0;bottom:0;width:12px;height:12px;cursor:nwse-resize;
 border-right:3px solid #5a6b4a;border-bottom:3px solid #5a6b4a}
.node{z-index:1}
</style></head><body>
<div id="bar">
 <input id="search" list="nodenames" placeholder="search nodes…" style="width:180px;background:#161a20;color:#ccc;border:1px solid #444;padding:3px"/>
 <datalist id="nodenames"></datalist>
 <button onclick="addNode()">add node</button>
 <select id="wfsel" title="open a saved or reference example workflow"></select>
 <button onclick="openWorkflow()">open</button>
 <button onclick="saveWorkflow()">save ⬇</button>
 <input id="wfile" type="file" accept=".json" style="display:none" onchange="loadFile(this)"/>
 <button onclick="document.getElementById('wfile').click()">load ⬆</button>
 <button onclick="submit()">run ▶</button>
 <button onclick="addGroup()" title="litegraph-style group frame">group ▭</button>
 <button onclick="undo()" title="ctrl+z">↶</button>
 <button onclick="redo()" title="ctrl+shift+z / ctrl+y">↷</button>
 <button onclick="clearAll()">clear</button>
 <progress id="p" value="0" max="1"></progress><span id="pt"></span>
 <span id="status"></span>
</div>
<div id="canvas"><svg id="wires"></svg></div>
<img id="preview"/>
<script>
let INFO={},nodes=[],links=[],groups=[],nid=1,lid=1,selPort=null;
// undo/redo: JSON snapshots of the whole graph, pushed BEFORE every mutation
let hist=[],hfut=[];
function ser(){return JSON.stringify({nodes,links,groups,nid,lid});}
function deser(s){const d=JSON.parse(s);nodes=d.nodes;links=d.links;groups=d.groups||[];nid=d.nid;lid=d.lid;render();}
function snap(){hist.push(ser());if(hist.length>100)hist.shift();hfut=[];}
function undo(){if(!hist.length)return;hfut.push(ser());deser(hist.pop());}
function redo(){if(!hfut.length)return;hist.push(ser());deser(hfut.pop());}
document.addEventListener('keydown',e=>{
 if(e.target.tagName==='INPUT'||e.target.tagName==='SELECT')return;
 if((e.ctrlKey||e.metaKey)&&e.key.toLowerCase()==='z'&&!e.shiftKey){e.preventDefault();undo();}
 else if((e.ctrlKey||e.metaKey)&&(e.key.toLowerCase()==='y'||(e.key.toLowerCase()==='z'&&e.shiftKey))){e.preventDefault();redo();}});
const canvas=document.getElementById('canvas');
fetch('/object_info').then(r=>r.json()).then(d=>{INFO=d;
 const dl=document.getElementById('nodenames');
 Object.keys(d).sort().forEach(n=>{const o=document.createElement('option');o.value=n;dl.appendChild(o);});
 // seed a starter graph
 ['CheckpointLoaderSimple','CLIPTextEncode','EmptyLatentImage','KSampler','VAEDecode','InferenceOutput']
  .forEach((t,i)=>addNode(t,30+i*190,60+(i%2)*230));
});
fetch('/workflows').then(r=>r.json()).then(d=>{
 const sel=document.getElementById('wfsel');
 (d.saved||[]).forEach(n=>{const o=document.createElement('option');o.value=o.textContent=n;sel.appendChild(o);});
 (d.examples||[]).forEach(n=>{const o=document.createElement('option');o.value=n;o.textContent='[ref] '+n;sel.appendChild(o);});
}).catch(()=>{});
function searchType(){
 const q=document.getElementById('search').value;
 if(INFO[q])return q;
 const ks=Object.keys(INFO),ql=q.toLowerCase();
 return ks.find(k=>k.toLowerCase()===ql)||ks.find(k=>k.toLowerCase().includes(ql));}
async function openWorkflow(){
 const name=document.getElementById('wfsel').value;if(!name)return;
 const r=await fetch('/workflows/'+encodeURIComponent(name));
 if(r.ok)importGraph(await r.json());
 else document.getElementById('status').textContent='load failed';}
async function saveWorkflow(){
 const wf=buildWorkflow();
 // include editor positions so a reload restores the layout
 wf.nodes.forEach(w=>{const n=nodes.find(x=>x.id===w.id);if(n)w.pos=[n.x,n.y];});
 const name=prompt('save as (server name, empty = download only)','my-workflow');
 if(name){
  const r=await fetch('/workflows/save',{method:'POST',
   body:JSON.stringify({name,workflow:wf})});
  document.getElementById('status').textContent=r.ok?'saved '+name:'save failed';
  if(r.ok)return;}
 const blob=new Blob([JSON.stringify(wf,null,1)],{type:'application/json'});
 const a=document.createElement('a');a.href=URL.createObjectURL(blob);
 a.download='workflow.json';a.click();}
function loadFile(inp){const f=inp.files[0];if(!f)return;
 f.text().then(t=>importGraph(JSON.parse(t)));inp.value='';}
function importGraph(wf){
 // UI-format JSON (the reference's saved graphs + our own): nodes with
 // pos/widgets_values/inputs[{name,link}], links [[id,src,srcSlot,dst,dstSlot,ty]]
 nodes=[];links=[];
 groups=(wf.groups||[]).map(g=>({title:g.title||'Group',
  x:g.bounding?g.bounding[0]:(g.x||80),y:g.bounding?g.bounding[1]:(g.y||80),
  w:g.bounding?g.bounding[2]:(g.w||420),h:g.bounding?g.bounding[3]:(g.h||260),
  color:g.color}));
 const ws=wf.nodes||[];
 let maxId=0;
 for(let i=0;i<ws.length;i++){const w=ws[i];
  const id=+w.id;maxId=Math.max(maxId,id);
  const n={id,type:w.type,x:(w.pos&&w.pos[0]!=null)?+w.pos[0]:30+ (i%5)*200,
           y:(w.pos&&w.pos[1]!=null)?+w.pos[1]:60+Math.floor(i/5)*240,widgets:{}};
  const keys=widgetsOf(w.type).map(([k])=>k);
  (w.widgets_values||[]).forEach((v,j)=>{if(keys[j]!=null)n.widgets[keys[j]]=v;});
  nodes.push(n);}
 const byLink={};
 for(const w of ws)for(const inp of (w.inputs||[]))
  if(inp.link!=null)byLink[inp.link]={dst:+w.id,dstName:inp.name};
 let maxL=0;
 for(const l of (wf.links||[])){
  const [id,src,srcSlot,dst,dstSlot]=l;maxL=Math.max(maxL,+id);
  const meta=byLink[id]||{};
  const dstNode=nodes.find(n=>n.id===+dst);
  let dstName=meta.dstName;
  if(dstName==null&&dstNode){const li=linkInputsOf(dstNode.type);
   if(li[dstSlot])dstName=li[dstSlot][0];}
  links.push({id:+id,src:+src,srcSlot:+srcSlot,dst:+dst,dstSlot:+dstSlot,
              dstName:dstName||('in'+dstSlot)});}
 nid=maxId+1;lid=maxL+1;render();
 document.getElementById('status').textContent='loaded '+nodes.length+' nodes';}
function widgetsOf(t){const inf=INFO[t];if(!inf)return[];const req=inf.input.required||{};
 return Object.entries(req).filter(([k,v])=>{
  const ty=Array.isArray(v[0])?'COMBO':v[0];
  return ['INT','FLOAT','STRING','BOOLEAN','COMBO'].includes(ty)||Array.isArray(v[0]);});}
function linkInputsOf(t){const inf=INFO[t];if(!inf)return[];const req=inf.input.required||{};
 return Object.entries(req).filter(([k,v])=>{
  const ty=Array.isArray(v[0])?'COMBO':v[0];
  return !['INT','FLOAT','STRING','BOOLEAN','COMBO'].includes(ty)&&!Array.isArray(v[0]);});}
function addGroup(x,y,w,h,title,color){snap();
 groups.push({title:title||'Group',x:x??80,y:y??80,w:w??420,h:h??260,color:color||'#3f5159'});render();}
function removeGroup(i){snap();groups.splice(i,1);render();}
function renderGroups(){
 canvas.querySelectorAll('.group').forEach(e=>e.remove());
 groups.forEach((g,i)=>{
  const d=document.createElement('div');d.className='group';
  d.style.left=g.x+'px';d.style.top=g.y+'px';d.style.width=g.w+'px';d.style.height=g.h+'px';
  if(g.color)d.style.borderColor=g.color;
  d.innerHTML=`<h5>${g.title} <span class="del" onclick="removeGroup(${i})">×</span></h5><div class="rsz"></div>`;
  canvas.appendChild(d);
  const h5=d.querySelector('h5');
  h5.ondblclick=()=>{const t=prompt('group title',g.title);if(t!=null){snap();g.title=t;render();}};
  h5.onmousedown=e=>{if(e.target.classList.contains('del'))return;snap();
   const sx=e.clientX-g.x,sy=e.clientY-g.y;
   // litegraph semantics: dragging a group moves the nodes inside it
   const inside=nodes.filter(n=>n.x>=g.x&&n.y>=g.y&&n.x<g.x+g.w&&n.y<g.y+g.h)
    .map(n=>({n,dx:n.x-g.x,dy:n.y-g.y}));
   const mv=ev=>{g.x=ev.clientX-sx;g.y=ev.clientY-sy;
    inside.forEach(({n,dx,dy})=>{n.x=g.x+dx;n.y=g.y+dy;});render();};
   const up=()=>{removeEventListener('mousemove',mv);removeEventListener('mouseup',up);};
   addEventListener('mousemove',mv);addEventListener('mouseup',up);};
  d.querySelector('.rsz').onmousedown=e=>{e.stopPropagation();snap();
   const sx=e.clientX-g.w,sy=e.clientY-g.h;
   const mv=ev=>{g.w=Math.max(120,ev.clientX-sx);g.h=Math.max(60,ev.clientY-sy);
    d.style.width=g.w+'px';d.style.height=g.h+'px';};
   const up=()=>{removeEventListener('mousemove',mv);removeEventListener('mouseup',up);};
   addEventListener('mousemove',mv);addEventListener('mouseup',up);};
 });}
function addNode(type,x,y){snap();type=type||searchType();
 if(!type||!INFO[type]){document.getElementById('status').textContent='no such node';return;}
 const n={id:nid++,type,x:x??(60+Math.random()*500),y:y??(80+Math.random()*300),widgets:{}};
 nodes.push(n);render();}
document.addEventListener('keydown',e=>{
 if(e.key==='Enter'&&document.activeElement===document.getElementById('search'))addNode();});
function removeNode(id){snap();nodes=nodes.filter(n=>n.id!==id);
 links=links.filter(l=>l.src!==id&&l.dst!==id);render();}
function render(){
 renderGroups();
 canvas.querySelectorAll('.node').forEach(e=>e.remove());
 for(const n of nodes){
  const d=document.createElement('div');d.className='node';d.style.left=n.x+'px';d.style.top=n.y+'px';d.dataset.id=n.id;
  const outs=(INFO[n.type]?.output)||['ANY'];
  let h=`<h4>${n.type} <span class="del" onclick="removeNode(${n.id})">×</span></h4>`;
  linkInputsOf(n.type).forEach(([k,v],i)=>{
   h+=`<div class="row"><span><span class="port in" data-n="${n.id}" data-slot="${i}" data-name="${k}"></span>${k} <i style="color:#666">${v[0]}</i></span></div>`;});
  outs.forEach((t,i)=>{
   h+=`<div class="row"><span></span><span>${t} <span class="port out" data-n="${n.id}" data-slot="${i}"></span></span></div>`;});
  widgetsOf(n.type).forEach(([k,v])=>{
   const cur=n.widgets[k]??'';
   if(Array.isArray(v[0])){
    h+=`<div class="row">${k}<select data-w="${k}">${v[0].map(c=>`<option ${c==cur?'selected':''}>${c}</option>`).join('')}</select></div>`;
   }else{h+=`<div class="row">${k}<input data-w="${k}" value="${cur}"/></div>`;}});
  d.innerHTML=h;canvas.appendChild(d);
  d.querySelector('h4').onmousedown=e=>{snap();const sx=e.clientX-n.x,sy=e.clientY-n.y;
   const mv=ev=>{n.x=ev.clientX-sx;n.y=ev.clientY-sy;d.style.left=n.x+'px';d.style.top=n.y+'px';drawWires();};
   const up=()=>{removeEventListener('mousemove',mv);removeEventListener('mouseup',up);};
   addEventListener('mousemove',mv);addEventListener('mouseup',up);};
  d.querySelectorAll('[data-w]').forEach(el=>el.onchange=()=>{snap();n.widgets[el.dataset.w]=el.value;});
  d.querySelectorAll('.port').forEach(p=>p.onclick=()=>portClick(p));
 }
 drawWires();}
function portClick(p){
 if(p.classList.contains('out')){document.querySelectorAll('.port.sel').forEach(e=>e.classList.remove('sel'));
  p.classList.add('sel');selPort=p;return;}
 if(selPort&&p.classList.contains('in')){snap();
  const dst=+p.dataset.n;
  links=links.filter(l=>!(l.dst===dst&&l.dstName===p.dataset.name));
  links.push({id:lid++,src:+selPort.dataset.n,srcSlot:+selPort.dataset.slot,
              dst,dstSlot:+p.dataset.slot,dstName:p.dataset.name});
  selPort.classList.remove('sel');selPort=null;drawWires();}}
function portPos(nId,slot,kind,name){
 const d=canvas.querySelector(`.node[data-id="${nId}"]`);if(!d)return null;
 const sel=kind==='out'?`.port.out[data-slot="${slot}"]`:`.port.in[data-name="${name}"]`;
 const p=d.querySelector(sel);if(!p)return null;const r=p.getBoundingClientRect(),c=canvas.getBoundingClientRect();
 return[r.left-c.left+5,r.top-c.top+5];}
function drawWires(){const svg=document.getElementById('wires');
 svg.innerHTML=links.map(l=>{
  const a=portPos(l.src,l.srcSlot,'out'),b=portPos(l.dst,l.dstSlot,'in',l.dstName);
  if(!a||!b)return'';
  return`<path d="M${a[0]},${a[1]} C${a[0]+60},${a[1]} ${b[0]-60},${b[1]} ${b[0]},${b[1]}" stroke="#7aa2f7" fill="none" stroke-width="2"/>`;
 }).join('');}
function buildWorkflow(){
 return{nodes:nodes.map(n=>({id:n.id,type:n.type,
   widgets_values:widgetsOf(n.type).map(([k])=>n.widgets[k]??''),
   inputs:links.filter(l=>l.dst===n.id).map(l=>({name:l.dstName,link:l.id}))})),
  links:links.map(l=>[l.id,l.src,l.srcSlot,l.dst,l.dstSlot,'ANY']),
  groups:groups.map(g=>({title:g.title,bounding:[g.x,g.y,g.w,g.h],color:g.color}))};}
async function submit(){
 const st=document.getElementById('status');
 try{const r=await fetch('/prompt',{method:'POST',body:JSON.stringify({prompt:buildWorkflow()})});
  st.textContent='queued #'+(await r.json()).prompt_id;}
 catch(e){st.textContent=String(e);}}
function clearAll(){snap();nodes=[];links=[];groups=[];render();}
const es=new EventSource('/events');
es.onmessage=m=>{const e=JSON.parse(m.data);const st=document.getElementById('status');
 if(e.type==='progress'){const d=e.data;
  document.getElementById('p').value=d.step;document.getElementById('p').max=d.total;
  document.getElementById('pt').textContent=d.step+'/'+d.total;
  if(d.preview){const im=document.getElementById('preview');
   im.src='data:image/jpeg;base64,'+d.preview;im.style.display='block';}}
 if(e.type==='executed')st.textContent='done: '+e.data.status;
 if(e.type==='execution_start'){st.textContent='running #'+e.data.prompt_id;
  document.querySelectorAll('.node').forEach(d=>d.style.borderColor='');}
 if(e.type==='execution_error'){const d=e.data;
  st.textContent='error @ '+d.node_type+' #'+d.node_id+': '+d.exception_message;
  const el=canvas.querySelector(`.node[data-id="${d.node_id}"]`);
  if(el)el.style.borderColor='#f7768e';}};
</script></body></html>""".encode("utf-8")


HIERARCHY_HTML = r"""<!doctype html>
<html><head><title>stable_renderer_tpu_torch scene hierarchy</title><style>
body{background:#14161a;color:#ccc;font-family:system-ui,sans-serif;margin:0;display:flex;height:100vh}
#tree{width:280px;overflow:auto;background:#1d2127;border-right:1px solid #333;padding:8px}
#tree .obj{cursor:pointer;padding:2px 6px;border-radius:4px;font-size:13px;white-space:nowrap}
#tree .obj:hover{background:#2d3340}
#tree .obj.sel{background:#3a4252;color:#fff}
#tree .inactive{opacity:.45}
#inspector{width:320px;background:#1d2127;border-left:1px solid #333;padding:12px;overflow:auto}
#inspector h3{margin:2px 0 10px;font-size:14px}
#inspector label{display:block;font-size:11px;color:#888;margin:8px 0 2px}
#inspector input[type=number]{width:72px;background:#161a20;color:#ccc;border:1px solid #444;font-size:12px;padding:2px}
#inspector .comp{font-size:12px;background:#23272f;border:1px solid #3a4252;border-radius:4px;padding:3px 8px;margin:3px 0}
#view{flex:1;display:flex;align-items:center;justify-content:center;background:#0d0f12}
#view img{max-width:100%;max-height:100%}
button{background:#2d3340;color:#ddd;border:1px solid #555;border-radius:4px;padding:4px 12px;cursor:pointer;margin-top:10px}
button:hover{background:#3a4252}
.muted{color:#666;font-size:12px}
</style></head><body>
<div id="tree"><div class="muted">loading scene…</div></div>
<div id="view"><img id="frame" src="/stream"/></div>
<div id="inspector"><div class="muted">select a GameObject</div></div>
<script>
let SCENE=[],SEL=null;
function flat(ns,d,out){for(const n of ns){out.push([n,d]);flat(n.children||[],d+1,out);}return out}
function renderTree(){
  const t=document.getElementById('tree');t.innerHTML='';
  for(const [n,d] of flat(SCENE,0,[])){
    const div=document.createElement('div');
    div.className='obj'+(n.active?'':' inactive')+(SEL&&SEL.name===n.name?' sel':'');
    div.style.paddingLeft=(6+d*16)+'px';
    div.textContent=(n.children&&n.children.length?'▾ ':'· ')+n.name;
    div.onclick=()=>{SEL=n;renderTree();renderInspector();};
    t.appendChild(div);
  }
}
function vec(label,key){
  const v=SEL.transform[key];
  return `<label>${label}</label>`+[0,1,2].map(i=>
    `<input type=number step=0.1 id="${key}${i}" value="${v[i].toFixed(3)}">`).join(' ');
}
function renderInspector(){
  const el=document.getElementById('inspector');
  if(!SEL){el.innerHTML='<div class=muted>select a GameObject</div>';return;}
  el.innerHTML=`<h3>${SEL.name}</h3>
   <label><input type=checkbox id=active ${SEL.active?'checked':''}> active</label>
   ${vec('position','position')}${vec('rotation (deg)','eulerAngles')}${vec('scale','scale')}
   <label>components</label>`+
   SEL.components.map(c=>`<div class=comp>${c}</div>`).join('')+
   (SEL.tags.length?`<label>tags</label><div class=muted>${SEL.tags.join(', ')}</div>`:'')+
   `<br><button onclick="apply()">apply</button> <span id=msg class=muted></span>`;
}
async function apply(){
  const g=k=>[0,1,2].map(i=>parseFloat(document.getElementById(k+i).value));
  const body={name:SEL.name,active:document.getElementById('active').checked,
              position:g('position'),eulerAngles:g('eulerAngles'),scale:g('scale')};
  const r=await fetch('/scene/update',{method:'POST',body:JSON.stringify(body)});
  document.getElementById('msg').textContent=r.ok?'applied':'error';
  load();
}
async function load(){
  try{
    const r=await fetch('/scene');
    if(!r.ok){document.getElementById('tree').innerHTML='<div class=muted>no engine attached</div>';return;}
    SCENE=(await r.json()).scene;
    if(SEL){const f=flat(SCENE,0,[]).find(([n])=>n.name===SEL.name);SEL=f?f[0]:null;}
    renderTree();if(SEL)renderInspector();
  }catch(e){}
}
load();setInterval(load,2000);
</script></body></html>""".encode()
