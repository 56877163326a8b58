"""Rules + LLM verifier with self-consistency and claim-check.

The port's copy of ``a_modular_rag_framework_tpu/modules/verification/impl_rules_llm.py``.

Behavior parity with the reference implementation's app/modules/verification/
impl_rules_llm.py:16-573:
  - rules channel: [#k] citation extraction, count/coverage/length
    heuristics combined multiplicatively;
  - LLM channel: sc_runs forced-JSON fact-checks, verdict->score fallback
    map, majority verdict + agreement rate, secondary-fact penalty;
  - FEVER-style claim-check: stub labels by default; when an external claim
    retriever is wired (the query engine), each claim is re-retrieved
    and labeled supported / not_enough_info by evidence overlap — the
    claims then drive the orchestrator's retry-retrieval loop;
  - hallucination-risk map; weighted final score; fine verdict map
    (PASS / PASS-WITH-NOISE / PARTIAL / FAIL-CONTRADICTED / INCONCLUSIVE);
  - StatusDetail enum + recommended actions; verifier metrics telemetry.
"""
from __future__ import annotations

import json
import logging
import re
from collections import Counter
from enum import Enum
from typing import Any, Callable, Dict, List, Optional, Tuple

from ...core.dto import Hit, VerifyIn, VerifyOut
from ...core.llm_router import LLMRouter
from ...telemetry.sinks import TelemetrySink, record_metrics, span

logger = logging.getLogger(__name__)

ExternalClaimRetriever = Callable[[str, List[str], str], List[Hit]]


class StatusDetail(str, Enum):
    """Fine-grained verification state on top of pass/fail.

    FAIL            explicit contradiction or missing core evidence ->
                    orchestrator triggers the retry-retrieval loop.
    HIGH_CONF_PASS  core facts directly supported -> accept.
    LOW_CONF_PASS   indirect/noisy support -> accept, consider re-check.
    UNKNOWN_PASS    no contradiction but weak support -> review.
    """

    FAIL = "fail"
    HIGH_CONF_PASS = "high_conf_pass"
    LOW_CONF_PASS = "low_conf_pass"
    UNKNOWN_PASS = "unknown_pass"


_STATUS_LABELS = {
    StatusDetail.FAIL: "Fail",
    StatusDetail.HIGH_CONF_PASS: "High Confidence Pass",
    StatusDetail.LOW_CONF_PASS: "Low Confidence Pass",
    StatusDetail.UNKNOWN_PASS: "Unknown Confidence Pass",
}


def _bounded(v: float, lo: float = 0.0, hi: float = 1.0) -> float:
    return max(lo, min(hi, float(v)))


def extract_citation_ids(answer: str) -> List[int]:
    """Pull [#k] citation numbers out of an answer."""
    out: List[int] = []
    for m in re.finditer(r"\[#(\d+)\]", answer or ""):
        try:
            out.append(int(m.group(1)))
        except ValueError:
            continue
    return out


def _evidence_block(evidence: List[Hit]) -> str:
    lines = []
    for i, h in enumerate(evidence, 1):
        meta = h.meta or {}
        doc = str(meta.get("doc") or meta.get("title") or "")
        sid = str(meta.get("sent_id") if meta.get("sent_id") is not None else "")
        text = str(meta.get("text") or "").replace('"', "“")
        lines.append(f'[#{i}] (doc={doc}, sent_id={sid}) "{text}"')
    return "\n".join(lines)


def _safe_json(s: str) -> Optional[Dict[str, Any]]:
    try:
        return json.loads(s)
    except (json.JSONDecodeError, TypeError):
        m = re.search(r"\{.*\}", s or "", re.S)
        if m:
            try:
                return json.loads(m.group(0))
            except json.JSONDecodeError:
                return None
        return None


_WH_RE = re.compile(r"\b(what|which|who|whose|where|when|how)\b", re.I)
_GROUND_STOP = {
    "the", "a", "an", "of", "in", "on", "at", "for", "to", "and", "or",
    "was", "is", "did", "does", "his", "her", "their", "its", "he",
    "she", "they", "with", "by", "as", "from", "which", "what", "who",
    "where", "when", "why", "how", "man", "woman", "person",
}


def _stemset(text: str) -> set:
    out = set()
    for t in re.findall(r"[a-z0-9]+", (text or "").lower()):
        if t in _GROUND_STOP or len(t) < 3:
            continue
        if t == "born" or t.startswith("birth"):
            t = "born"
        out.add(t[:6])
    return out


def ground_answer(question: str, answer: str,
                  evidence: List[Hit]) -> Dict[str, Any]:
    """Deterministic evidence-grounding signals (the teeth the round-4
    review found missing — every one of 60 wrong natural-corpus answers
    was stamped PASS-WITH-NOISE):

      span_grounded  — the answer span (citations stripped) appears in
                       at least one evidence text;
      chain_anchored — a span-holding evidence connects to the question:
                       its doc names a question entity, or another
                       evidence names both a question entity and the
                       holder's doc (the 2-hop bridge shape);
      ask_covered    — the question's asked-relation words (after the
                       last wh-word) stem-match a span-holder's text.

    Pure string analysis over the verifier's own inputs — no LLM, so the
    signals hold with mock providers and are independent of the
    reasoner's evidence scoring."""
    span = re.sub(r"\[#\d+\]", " ", answer or "")
    span = re.sub(r"\s+", " ", span).strip().strip('."” ').strip()
    out = {"span": span[:80], "span_grounded": False,
           "chain_anchored": False, "ask_covered": False}
    if not span or not evidence:
        return out

    docs = []
    for h in evidence:
        meta = h.meta if isinstance(h.meta, dict) else {}
        docs.append((str(meta.get("doc") or meta.get("title") or ""),
                     str(meta.get("text") or "")))

    span_l = span.lower()
    holders = [i for i, (title, text) in enumerate(docs)
               if span_l in re.sub(r"\s+", " ", text).lower()
               or span_l in title.lower()]
    out["span_grounded"] = bool(holders)
    if not holders:
        return out

    # a span of sentence length is a non-answer (the extractive fallback
    # echoing a whole evidence line) — trivially "grounded", never an
    # answer span; flag as uncovered so the retry loop gets a shot
    if len(span.split()) >= 10:
        out["non_extractive"] = True
        return out

    # question entities: capitalized multi-char spans of the question,
    # PLUS any evidence doc whose title appears in the question — the
    # topic is often lowercase in natural questions ("the discoverer of
    # polonium") and stray proper adjectives ("Russian") must not anchor
    # on their own when a real topic title is present
    q_ents = [e.lower() for e in re.findall(
        r"(?<![\w'])[A-Z][\w'\-]*(?: [A-Z][\w'\-]*)*", question or "")
        if len(e) >= 3]
    q_ents = [e for e in q_ents if _stemset(e) - {"the"}]
    ql = (question or "").lower()
    title_ents = []
    for title, _ in docs:
        main = title.split(" (")[0].strip().lower()
        if len(main) >= 3 and main in ql and main not in title_ents:
            title_ents.append(main)
    if title_ents:
        q_ents = title_ents + [e for e in q_ents
                               if any(e in t or t in e
                                      for t in title_ents)]

    def names_q(title: str, text: str) -> bool:
        blob = f"{title} ‖ {text}".lower()
        return any(e in blob for e in q_ents)

    anchored = set()
    for i in holders:
        h_title, h_text = docs[i]
        if names_q(h_title, h_text):
            anchored.add(i)
            continue
        ht = h_title.lower()
        for j, (title2, text2) in enumerate(docs):
            if j == i or not names_q(title2, text2):
                continue
            # bridge: the question-doc names the holder's subject (or
            # vice versa) — the hop-1 link sentence shape
            if (ht and ht.split(" (")[0] in text2.lower()) or \
                    (title2 and title2.lower().split(" (")[0]
                     in h_text.lower()):
                anchored.add(i)
                break
    out["chain_anchored"] = bool(anchored)

    wh = None
    for m in _WH_RE.finditer(question or ""):
        wh = m
    ask = _stemset((question or "")[wh.end():] if wh else question)
    ask -= _stemset(" ".join(e for e in q_ents))
    ask -= _stemset(span)
    check = anchored or holders
    if not ask:
        out["ask_covered"] = True
    else:
        out["ask_covered"] = any(
            ask & (_stemset(docs[i][1]) | _stemset(docs[i][0]))
            for i in check)
    return out


def hallucination_risk(verdict: str, consistency: float) -> float:
    """contradicted -> high base risk, insufficient -> medium, else low;
    modulated by (1 - consistency)."""
    base = {"contradicted": 0.9, "refuted": 0.9, "insufficient": 0.6}.get(verdict, 0.2)
    return _bounded(0.5 * base + 0.5 * (1.0 - consistency))


def map_fine_verdict(
    core_supported: bool,
    core_missing: bool,
    contradicted: bool,
    noisy: bool,
    agreement_rate: float,
    core_indirect: bool = False,
) -> str:
    """Resolve channel signals into one of the five fine verdicts.

    Evaluated as a first-match precedence table (strongest signal wins):
    an explicit, directly-evidenced contradiction fails the answer; runs
    that cannot agree are inconclusive; directly supported answers pass
    (demoted one notch when noisy citations are present); everything
    else — indirect-only support or missing core evidence — is PARTIAL.
    Same decision surface as the reference verifier
    (the reference implementation's app/modules/verification/impl_rules_llm.py:177-197).
    """
    # "indirect-only" = every core fact implied but none stated AND no core
    # fact is missing either; indirect + missing still counts as a pass in
    # the reference's decision surface (kept for parity)
    indirect_only = core_indirect and not core_missing
    passes = core_supported and not indirect_only
    ladder = (
        (contradicted and not core_indirect, "FAIL-CONTRADICTED"),
        (agreement_rate < 0.5, "INCONCLUSIVE"),
        (core_supported and indirect_only, "PARTIAL"),
        (passes and noisy, "PASS-WITH-NOISE"),
        (passes, "PASS"),
    )
    for fired, verdict in ladder:
        if fired:
            return verdict
    return "PARTIAL"


class VerifierAgentRulesLLM:
    def __init__(
        self,
        router: LLMRouter,
        sink: Optional[TelemetrySink] = None,
        *,
        min_citations: int = 1,
        min_coverage_ratio: float = 0.2,
        require_citation_in_answer: bool = True,
        temperature: float = 0.0,
        ctx: int = 64000,
        weight_rules: float = 0.4,
        weight_llm: float = 0.6,
        weight_risk: float = 0.0,
        decision_threshold: float = 0.6,
        sc_runs: int = 5,
        sc_agreement_threshold: float = 0.7,
        enable_claim_check: bool = True,
        external_claim_retriever: Optional[ExternalClaimRetriever] = None,
        max_claims: int = 5,
        use_llm: bool = True,
    ):
        self.router = router
        self.sink = sink
        self.min_citations = int(min_citations)
        self.min_coverage_ratio = float(min_coverage_ratio)
        self.require_citation_in_answer = require_citation_in_answer
        self.temperature = float(temperature)
        self.ctx = int(ctx)
        self.weight_rules = float(weight_rules)
        self.weight_llm = float(weight_llm)
        self.weight_risk = float(weight_risk)
        self.decision_threshold = float(decision_threshold)
        self.sc_runs = max(1, int(sc_runs))
        self.sc_agreement_threshold = float(sc_agreement_threshold)
        self.enable_claim_check = enable_claim_check
        self.external_claim_retriever = external_claim_retriever
        self.max_claims = int(max_claims)
        self.use_llm = use_llm

    # ---- rules channel ----

    def _rule_check(self, question: str, answer: str, evidence: List[Hit]) -> Tuple[float, List[str], Dict[str, Any]]:
        issues: List[str] = []
        diag: Dict[str, Any] = {}
        if not (answer and answer.strip()):
            return 0.0, ["Empty answer."], diag

        score = 1.0
        cited = extract_citation_ids(answer)
        if self.require_citation_in_answer:
            if not cited:
                issues.append("No inline citations like [#k] found in answer.")
                score *= 0.7
            if self.min_citations > 0 and len(cited) < self.min_citations:
                issues.append(
                    f"Not enough citations: found {len(cited)}, "
                    f"require >= {self.min_citations}."
                )
                score *= 0.85
            uniq = {i for i in cited if 1 <= i <= len(evidence)}
            coverage = len(uniq) / max(1, len(evidence)) if evidence else 0.0
            diag["coverage"] = coverage
            if coverage < self.min_coverage_ratio:
                issues.append(
                    f"Citation coverage low: {coverage:.2f} < "
                    f"{self.min_coverage_ratio:.2f}."
                )
                score *= 0.9
        else:
            uniq = {i for i in cited if 1 <= i <= len(evidence)}
            diag["coverage"] = len(uniq) / max(1, len(evidence)) if evidence else 0.0

        if not evidence:
            issues.append("No evidence provided.")
            score *= 0.8
        if len(answer) > 400 and not cited:
            issues.append("Long answer without citations.")
            score *= 0.9
        return _bounded(score), issues, diag

    # ---- LLM channel ----

    def _fact_check_once(self, question: str, answer: str, evidence: List[Hit],
                         trace_id: str) -> Tuple[float, Dict[str, Any]]:
        instructions = (
            "Fact-check the answer below against its citations and nothing "
            "else. Classify each fact the answer asserts as one of: "
            "supported, indirect (implied but not stated), unsupported "
            "(absent from the citations), or contradicted (a citation "
            "states the opposite — use this label only for explicit "
            "conflicts). Split the facts into core (needed to answer the "
            "question) and secondary. Sort the citation numbers into "
            "valid_citations / noisy_citations / misleading_citations "
            "(noisy = off-topic, misleading = off-topic and contradicting). "
            "An answer fails verification only when a core fact is "
            "contradicted.\n"
            "Respond with JSON only, shaped as: {core_facts, "
            "secondary_facts, facts: {core: [{fact, status}], secondary: "
            "[...]}, valid_citations, noisy_citations, "
            "misleading_citations, verdict: "
            "supported|partial|refuted|insufficient, score: 0..1}.\n"
        )
        prompt = (
            f"{instructions}\nQuestion:\n{question}\n\nAnswer:\n{answer}\n\n"
            f"Citations:\n{_evidence_block(evidence)}\n"
        )
        out = self.router.complete(
            module="VerifierAgent", purpose="factcheck", prompt=prompt,
            require={"context_window": self.ctx, "temperature": self.temperature,
                     "trace_id": trace_id},
        )
        text = out.get("text", "") if isinstance(out, dict) else str(out)
        data = _safe_json(text) or {}
        verdict = str(data.get("verdict") or "").lower()
        raw = data.get("score")
        if isinstance(raw, (int, float)):
            score = _bounded(float(raw))
        else:
            score = {"supported": 0.9, "partial": 0.5, "insufficient": 0.5,
                     "refuted": 0.1}.get(verdict, 0.3)
            data["score"] = score
        return score, data

    def _fact_check(self, question: str, answer: str, evidence: List[Hit],
                    trace_id: str) -> Tuple[float, List[str], Dict[str, Any]]:
        scores: List[float] = []
        verdicts: List[str] = []
        runs: List[Dict[str, Any]] = []
        for _ in range(self.sc_runs):
            s, d = self._fact_check_once(question, answer, evidence, trace_id)
            scores.append(_bounded(s))
            verdicts.append(str(d.get("verdict") or "insufficient"))
            runs.append(d)

        counts = Counter(verdicts)
        maj_verdict, n = counts.most_common(1)[0]
        agreement = n / max(1, len(verdicts))
        avg_score = _bounded(sum(scores) / max(1, len(scores)))

        issues: List[str] = []
        valid_union: List[Any] = []
        noisy_union: List[Any] = []
        misleading_union: List[Any] = []
        facts_agg: Dict[str, List[Dict[str, Any]]] = {"core": [], "secondary": []}
        for d in runs:
            issues.extend(str(x) for x in (d.get("issues") or []))
            for key, bag in (("valid_citations", valid_union),
                             ("noisy_citations", noisy_union),
                             ("misleading_citations", misleading_union)):
                for v in d.get(key) or []:
                    if v not in bag:
                        bag.append(v)
            for k in ("core", "secondary"):
                for item in (d.get("facts") or {}).get(k, [])[:8]:
                    if isinstance(item, dict):
                        facts_agg[k].append(item)

        diag = {
            "verdict": maj_verdict,
            "agreement_rate": float(agreement),
            "valid_citations": valid_union,
            "noisy_citations": noisy_union,
            "misleading_citations": misleading_union,
            "facts": facts_agg,
            "runs": len(runs),
            "runs_raw": runs[:3],
        }
        return avg_score, issues, diag

    # ---- claim check ----

    def _claim_check(self, question: str, answer: str, trace_id: str,
                     facts: Dict[str, Any]) -> Dict[str, Any]:
        claims: List[str] = []
        for k in ("core", "secondary"):
            for item in facts.get(k) or []:
                fact = str(item.get("fact") or "").strip()
                if fact:
                    claims.append(fact)
        claims = claims[: self.max_claims]

        results: List[Dict[str, Any]] = []
        summary = Counter()
        for claim in claims:
            label, rationale, ev = "not_enough_info", "", []
            if self.external_claim_retriever is not None:
                try:
                    hits = self.external_claim_retriever(claim, [], trace_id) or []
                    claim_terms = set(re.findall(r"[a-z0-9]+", claim.lower()))
                    for h in hits[:3]:
                        text = str((h.meta or {}).get("text") or "")
                        ev.append({"id": h.id, "text": text})
                        overlap = claim_terms & set(re.findall(r"[a-z0-9]+", text.lower()))
                        if claim_terms and len(overlap) / len(claim_terms) >= 0.6:
                            label = "supported"
                            rationale = "high lexical overlap with retrieved evidence"
                except Exception as e:
                    logger.warning("claim retrieval failed: %r", e)
            results.append({"claim": claim, "label": label,
                            "rationale": rationale, "evidence": ev})
            summary[label] += 1
        return {
            "results": results,
            "summary": {"supported": summary.get("supported", 0),
                        "refuted": summary.get("refuted", 0),
                        "not_enough_info": summary.get("not_enough_info", 0)},
        }

    # ---- main ----

    def verify(self, req: VerifyIn) -> VerifyOut:
        question = req.question or req.query or ""
        answer = req.answer or ""
        evidence = list(req.evidence or [])
        trace_id = req.trace_id or "trace-verify"
        retry_round = int(getattr(req, "retry_round", 0) or 0)

        with span("Verifier/Rules", self.sink, trace_id):
            r_score, r_issues, r_diag = self._rule_check(question, answer, evidence)

        if self.use_llm:
            with span("Verifier/LLM", self.sink, trace_id):
                l_score, l_issues, l_diag = self._fact_check(
                    question, answer, evidence, trace_id
                )
        else:
            l_score, l_issues, l_diag = r_score, [], {
                "verdict": "supported" if r_score >= self.decision_threshold else "insufficient",
                "agreement_rate": 1.0, "facts": {}, "runs": 0,
            }

        maj_verdict = str(l_diag.get("verdict") or "insufficient")
        agreement_rate = float(l_diag.get("agreement_rate") or 0.0)

        claim_diag: Dict[str, Any] = {}
        if self.enable_claim_check:
            with span("Verifier/ClaimCheck", self.sink, trace_id):
                claim_diag = self._claim_check(
                    question, answer, trace_id, l_diag.get("facts") or {}
                )

        coverage_score = float(r_diag.get("coverage") or 0.0)
        consistency_score = float(l_score)
        secondary = (l_diag.get("facts") or {}).get("secondary") or []
        if any(it.get("status") in ("unsupported", "contradicted") for it in secondary):
            consistency_score *= 0.9

        risk = hallucination_risk(maj_verdict, consistency_score)
        final_score = _bounded(
            self.weight_rules * r_score
            + self.weight_llm * consistency_score
            + self.weight_risk * (1.0 - risk)
        )

        core = (l_diag.get("facts") or {}).get("core") or []
        core_supported = (
            any(it.get("status") in ("supported", "indirect") for it in core)
            if core else (maj_verdict == "supported")
        )
        core_missing = any(it.get("status") == "unsupported" for it in core)
        contradicted = (maj_verdict in ("contradicted", "refuted")
                        or any(it.get("status") == "contradicted" for it in core))
        noisy = bool(l_diag.get("noisy_citations"))
        core_indirect = any(it.get("status") == "indirect" for it in core)

        fine_verdict = map_fine_verdict(
            core_supported, core_missing, contradicted, noisy, agreement_rate,
            core_indirect=core_indirect,
        )

        # Deterministic grounding gate over the LLM channel's verdict
        # (VERDICT r4 item 4: the verifier must be able to say no with
        # mock LLMs). An answer whose span appears in no evidence is
        # unsupported regardless of what the fact-check said; a grounded
        # span whose holder neither connects to the question's entities
        # nor covers the asked relation is inconclusive — both drive the
        # orchestrator's claim-retrieval retry. One missing signal only
        # demotes a clean PASS to PASS-WITH-NOISE (precision guard: the
        # asked relation is often a paraphrase of the evidence).
        grounding = ground_answer(question, answer, evidence)
        if answer.strip() and fine_verdict in (
                "PASS", "PASS-WITH-NOISE", "PARTIAL"):
            if not grounding["span_grounded"]:
                fine_verdict = "FAIL-UNSUPPORTED"
                l_issues = [*l_issues,
                            "Answer span not found in any evidence."]
            elif grounding.get("non_extractive"):
                fine_verdict = "INCONCLUSIVE"
                l_issues = [*l_issues,
                            "Answer echoes a whole evidence sentence "
                            "instead of an extracted span."]
            elif not (grounding["chain_anchored"]
                      or grounding["ask_covered"]):
                fine_verdict = "INCONCLUSIVE"
                l_issues = [*l_issues,
                            "Evidence holding the span neither names a "
                            "question entity nor covers the asked "
                            "relation."]
            elif fine_verdict == "PASS" and not (
                    grounding["chain_anchored"]
                    and grounding["ask_covered"]):
                fine_verdict = "PASS-WITH-NOISE"

        ok = fine_verdict in ("PASS", "PASS-WITH-NOISE", "PARTIAL")
        if not ok:
            status, status_detail = "fail", StatusDetail.FAIL
        elif fine_verdict == "PASS":
            status, status_detail = "pass", StatusDetail.HIGH_CONF_PASS
        elif fine_verdict in ("PASS-WITH-NOISE", "PARTIAL"):
            status, status_detail = "pass", StatusDetail.LOW_CONF_PASS
        else:
            status, status_detail = "pass", StatusDetail.UNKNOWN_PASS

        issues = [*r_issues, *l_issues]

        findings: List[Dict[str, Any]] = []
        if contradicted:
            findings.append({"type": "contradiction", "severity": "high"})
        if fine_verdict == "PASS-WITH-NOISE" and noisy:
            findings.append({"type": "redundant_citation", "severity": "low"})
        if fine_verdict == "PARTIAL":
            findings.append({"type": "partial_support", "severity": "medium"})
        if fine_verdict == "INCONCLUSIVE":
            findings.append({"type": "inconclusive", "severity": "medium"})

        diagnostics = {
            "rule_score": r_score,
            "grounding": grounding,
            "llm_score": consistency_score,
            "rule_diag": r_diag,
            "llm_diag": l_diag,
            "claim_check": claim_diag,
            "final_score_formula": {
                "weights": {"rules": self.weight_rules, "llm": self.weight_llm,
                            "risk": self.weight_risk},
                "threshold": self.decision_threshold,
            },
            "citations": {
                "valid": l_diag.get("valid_citations") or [],
                "noisy": l_diag.get("noisy_citations") or [],
                "misleading": l_diag.get("misleading_citations") or [],
            },
            "status_detail": status_detail.value,
            "status_detail_label": _STATUS_LABELS[status_detail],
            "retry_round": retry_round,
        }

        if self.sink:
            record_metrics(self.sink, trace_id, verifier={
                "coverage_score": coverage_score,
                "consistency_score": consistency_score,
                "hallucination_risk": risk,
                "final_score": final_score,
                "verdict": fine_verdict,
                "agreement_rate": agreement_rate,
                "issues_count": len(issues),
                "status": status,
                "status_detail": status_detail.value,
                "retry_round": retry_round,
            })

        if status_detail is StatusDetail.FAIL:
            recommended = ("Reject and re-run" if fine_verdict == "FAIL-CONTRADICTED"
                           else "Retry retrieval / claim-check")
        elif status_detail is StatusDetail.LOW_CONF_PASS:
            recommended = ("Accept; prune noisy citations"
                           if fine_verdict == "PASS-WITH-NOISE"
                           else "Review recommended (low confidence)")
        elif status_detail is StatusDetail.UNKNOWN_PASS:
            recommended = "Review required (uncertain evidence)"
        else:
            recommended = "Accept (high confidence)"

        return VerifyOut(
            status=status,
            findings=findings,
            model="llm+rules",
            ok=ok,
            score=final_score,
            issues=issues,
            diagnostics=diagnostics,
            coverage_score=coverage_score,
            consistency_score=consistency_score,
            hallucination_risk=risk,
            final_score=final_score,
            verdict=fine_verdict,
            self_consistency={
                "runs": int(l_diag.get("runs") or self.sc_runs),
                "agreement_rate": agreement_rate,
                "majority_verdict": maj_verdict,
            },
            recommended_action=recommended,
            status_detail=status_detail.value,
            status_detail_label=_STATUS_LABELS[status_detail],
        )
