#!/bin/bash
# Quick end-to-end service drive (the .claude/skills/verify recipe,
# scripted): launches both services on :8001/:8000 with the fake
# embedder, drives embed/search/batch/filter + error probes, exits
# nonzero on any failed check. The embedding service is numpy-only and
# never opens a JAX device, so the indexing service is the one JAX
# process. Usage: bash scripts/verify_drive.sh [config.yaml]
set -u
WORK=$(mktemp -d)
CFG=${1:-$WORK/config.yaml}
if [ ! -f "$CFG" ]; then
  mkdir -p "$WORK/data"
  cat > "$CFG" <<EOF
embedding: {model: "fake-64", dimension: 64}
device: cpu
index: {ef_construction: 60, M: 8, flush_threshold: 5}
vector_db: {file_path: $WORK/data/vdb, dimension: 64, capacity: 1024}
EOF
fi
CONFIG_PATH=$CFG PORT=8001 python -m vector_db_tpu.api.embedding_app \
  > "$WORK/verify_emb.log" 2>&1 &
EPID=$!
sleep 4
CONFIG_PATH=$CFG USE_EMBEDDING_SERVICE=true \
  EMBEDDING_SERVICE_URL=http://127.0.0.1:8001 PORT=8000 \
  python -m vector_db_tpu.api.app > "$WORK/verify_idx.log" 2>&1 &
IPID=$!
trap 'kill $EPID $IPID 2>/dev/null' EXIT
ok=1
for i in $(seq 1 40); do
  curl -sf http://127.0.0.1:8000/health > /dev/null 2>&1 && { ok=0; break; }
  sleep 2
done
[ $ok -ne 0 ] && { echo "FAIL: health never came up"; exit 1; }
TXT="verify drive $$ $(date +%s)"
R=$(curl -s -X POST http://127.0.0.1:8000/embed -H 'Content-Type: application/json' \
  -d "{\"content\": \"$TXT\", \"metadata\": {\"topic\": \"vd\"}}")
echo "$R" | grep -q '"status_code": 200' || { echo "FAIL embed: $R"; exit 1; }
S=$(curl -s -X POST http://127.0.0.1:8000/search -H 'Content-Type: application/json' \
  -d "{\"query\": \"$TXT\", \"top_k\": 2}")
echo "$S" | grep -q "$TXT" || { echo "FAIL search: $S"; exit 1; }
F=$(curl -s -X POST http://127.0.0.1:8000/search -H 'Content-Type: application/json' \
  -d "{\"query\": \"$TXT\", \"top_k\": 2, \"metadata_filter\": {\"topic\": \"vd\"}}")
echo "$F" | grep -q "$TXT" || { echo "FAIL filtered search: $F"; exit 1; }
B=$(curl -s -X POST http://127.0.0.1:8000/search/batch -H 'Content-Type: application/json' \
  -d "{\"queries\": [\"$TXT\"], \"top_k\": 1}")
echo "$B" | grep -q '"status_code": 200' || { echo "FAIL batch: $B"; exit 1; }
C=$(curl -s -o /dev/null -w '%{http_code}' -X POST http://127.0.0.1:8000/search \
  -H 'Content-Type: application/json' -d '{"bad": 1}')
[ "$C" = "422" ] || { echo "FAIL 422 probe: got $C"; exit 1; }
echo "VERIFY DRIVE OK (embed/search/filter/batch/422)"
