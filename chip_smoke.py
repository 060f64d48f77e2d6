#!/usr/bin/env python3
"""Smoke run of the PyTorch port's main path on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the batched scan-to-map main path of
`feature_base_pointcloud_registration_tpu_torch` (no JAX) at the bench's
size: B=256 distinct full VLP-16 scans of the synthetic world (seed 0),
`Params(map_corner_cap=16384, map_surf_cap=65536)`, cell caps 32/48,
round-0 strides 8/4, 2 rounds x 15 GN iterations.

  build    compiles csrc/*.cu with nvcc into build/ (ops/kernels.py);
  phase 1  the fetch kernel against its plain version on the main path's
           round-1 queries (corner and surf): d2 and candidates bitwise;
  phase 2  the GN-round kernel against its plain version on round 0's
           inputs (strided features, lanes at iteration 0, so the Jacobi
           runs) and on round 1's (phase 1's candidates): pose within 1e-3
           (m / rad), iteration count and n_corr equal on >= 95% of lanes;
  phase 3  the slice end to end: frontend, map tables, batch_register_fused,
           with the kernels' launch counters zeroed just before; each kernel
           must have launched (1 ring_pick, the batch's fast picking; 4
           fetches, 2 GN rounds, one a round); ATE
           against ground
           truth and against the serial NumPy oracle (tests/oracle.py) on 8
           scans, which must be <= 1e-3 m;
  phase 4  the resident-fetch kernel against its plain version on phase 1's
           queries routed through the resident tables' rows_index: bitwise;
           and against the raw-table fetch: d2 bitwise, candidates bitwise
           wherever the compact row is not the sentinel;
  phase 5  the main path on resident tables (frontend,
           build_map_planar_tables with resident=True, batch_register_fused),
           counted: 1 ring_pick, 4 resident fetches, 0 raw fetches, 2 GN
           rounds; poses within 1e-6 of phase 3's; ATE against the oracle
           <= 1e-3 m;
  phase 6  the frontend and the rounds-structured solver
           batch_register_pallas on the resident tables, counted: 1
           ring_pick, 4 resident fetches, 0 GN rounds, 2 rounds_gn (one a
           round); ATE
           against the oracle <= 1e-3 m; batch_register_blocks (plain fetch,
           same solver) on the first 32 scans within 1e-4 of it;
  timing   CUDA events (a GN call through a replayed CUDA graph of its
           calls, since one of a few iterations is shorter than its host
           launch): each kernel beside its plain version at these
           shapes (the GN round at both rounds' inputs), with its bound
           (bytes read once over 3.35 TB/s or operations over 67 TFLOP/s
           fp32, whichever is larger; a fetch reads each table row its
           live queries name once; the GN round reads the mask of every
           point and the xyz and candidates of live ones; also the floor of a
           design that streams the candidates every iteration: lane-
           iterations x live points x (16 + 12K) B over 3.35 TB/s);
           frontend and solve ms/scan, end-to-end scans/s, the frontend
           and e2e also with the picking on its plain version (the MIS
           rounds, the route before the ring-pick kernel);
  probes   both fetch kernels at phase 4's round-1 surf queries: (a) as
           they are, (b) after a per-lane sort by row (presort_by_row,
           the order of JAX presort_rows), (c) every query at
           the sentinel (the writes alone), (d) every live query on one
           row (the cached ceiling), and K = 6/8/16 on (a); with the live
           queries, the distinct (tile, row) pairs of the kernels' query
           tiles and the row bytes each pattern reads; the GN kernel at
           both rounds' inputs: (a) as they are, with the histogram of
           per-lane iterations and us per lane-iteration, (b) every valid
           lane at exactly 1 and 15 iterations (convergence thresholds 0),
           (c) live features only (each lane's live features and their
           candidates packed to the front, P cut to the batch's largest
           live count), (d) one lane per SM against all B lanes, (e) at
           round 0, one iteration with the 6-sweep Jacobi against none, (f)
           round 1 at K = 6 and 16;
  phase 7  the single-scan localization pipeline at default Params (strict
           picking, deskew, crop +-(30, 30, 10) m, register grid
           +-(60, 60, 25) m, 3 rounds x 10 iterations, K=16): the world's
           map written with the port's write_pcd and loaded with
           GlobalMap.from_pcd_dir; 20 motion-skewed scans 0.2 s apart along
           constant_twist_platform, each through ScanBuffer, imu_converter,
           make_deskew_info (OdomQueue's increment) and
           LocalizationPipeline.step, counted: 1 ring_pick and 6 fetches
           of K=16 a step (resident_fetch or block_fetch by table kind), 0
           GN rounds, 3 rounds_gn (one a round), 0 host syncs in picking
           and in the solve (register_rounds_core; the CUDA sync debug
           mode; the solve of steps 0-2 also checks its fetches); the
           fetches of steps 0-2 bitwise equal to their plain versions;
           steps 0-2 within 1e-4 of the same steps on the CPU; strict picks
           of scans 0-2 equal to the oracle's, scan 0's deskewed points
           within 2e-5 m of the oracle's (rotation); a scan 0.05 s later
           gated; max translation error after step 0 < 0.06 m and ATE <
           0.05 m against the ground truth; times of the step and its
           stages; the frontend's split (projection + deskew, ring
           windows, picking, voxel thinning) and the step's time with the
           picking on the kernel and on its plain version in turns; the
           step's time, split and solve syncs with the rounds solver's
           iterations on rounds_gn and on the parent's loop
           (rounds_gn_reference) in turns; the step's time and split, and
           a profiled step's device-busy share, with rounds_gn at the
           rule's cluster size and at one CTA a lane, in turns; the
           ring-pick kernel bitwise against its plain version, timed
           beside it and its bound (and through a replayed CUDA graph of
           its calls), at (a) this phase's scan (B=1, strict), (b) phase
           3's batch (B=256, fast), (c) the HDL-64 scans of
           tests/data/kitti_mini and a 64-ring synthetic scan (strict),
           (d) tests/pick_windows.py's windows (both modes), with the
           clock64 split of a window (load, sorts, corner walks, surf
           walks, tail) from ring_pick.cu's diagnostic build
           (-DFBPR_RING_PICK_PROFILE) at (a)-(c);
           each table's kind and bytes, the
           fetch beside its bound, ptxas of the K=16 fetch instances;
           each table on grid_register_step's row space (lower_pad: a
           row for every octant base from -1) beside the batched solvers';
           (g) grid_register_step with the grid's lower x face 0.5 m behind
           the room's x = -25 m wall (tests/test_torch_register_fast.py's
           scene, half extent (25.8, 30, 10)), counted (6 K=16 fetches, 0
           GN rounds, each bitwise its plain version); at the guess the
           queries within half a cell of a lower face counted, and the
           candidates kept for them by resident_fetch and block_fetch (the
           step's compact and raw tables) and by their plain versions,
           bitwise equal and equal to grid_knn_oct_sentinel's, beside the
           batched row space's (none); the pose within 1e-4 of the CPU's;
           `launches_lower_face` in the kernels line;
           (h) phase 7's first 10 steps on an undownsampled map (the
           room's surf points at 0.2 m, GlobalMap.from_pcd_dir(downsample=
           False), Params(map_surf_cap=131072), examples/run_kitti_slam.py's
           HDL-64 cap): the crop keeps every surf point, its compact table
           passes the 10 MiB resident cap, so the surf table stays raw
           (W 512, ~683 MB) and block_fetch runs at K=16 on the path;
           counted: 3 block_fetch and 3 resident_fetch (the compact corner
           table) a step, 0 GN rounds, 3 rounds_gn; the fetches of steps
           0-2 bitwise
           their plain versions; steps 0-2 within 1e-3 of the CPU, and
           within 1e-4 with collinear 5-NN plane fits rejected (on the
           lattice the rank gate passes some on rounding noise); max
           translation error after step 0 < 0.06 m, ATE < 0.05 m; each
           step's pose beside phase 7's; the step time and its split, a
           profiled step, the table kinds, rows and bytes, the K=16 W=512
           fetch beside its bound and plain version, ptxas of its
           instance; `launches_raw_step` and `raw_step` in the kernels
           line; then `probe rounds_gn` lines: the rounds kernel against
           its plain version on the card (rounds_gn_reference, the port's
           loop body) at (a) phase 7 step 0's round 0 (B=1, K=16), (b)
           phase 6's round 0 (B=256, K=8), (c) phase 7 (h) step 0's round
           0, (d) tests/rounds_scenes.py's edge lanes at K 8 and 16 (a
           gated-off lane, a lane under min_corr, the degenerate tiny
           problem, sentinel picks near the world origin, min_plane_spread
           0.05 at K 16): pose and matP within 1e-5 on lanes whose flags,
           iterations and n_corr agree, a degenerate lane's pose within
           1e-3, agreement on >= 95% of lanes of a batch (a flip printed
           at any B), two launches bitwise, each timed beside its plain
           version and its bound, at the rule's cluster size
           (kernels.rounds_gn_cluster) and, at (a), (c) and (d), at every
           cluster size 1-16; (a) and (c) timed at the rule's size and at
           1 in turns; the clock64 split of an iteration (point loop,
           in-CTA reduction, cluster combine, tail) from rounds_gn.cu's
           diagnostic build (-DFBPR_ROUNDS_PROFILE) at (a), (b) round 1,
           (c) and each swept size; ptxas of the shipped, FMA and
           diagnostic builds; the resident clusters of each size; the C
           sweep (one K=16 lane of P = 320 to 10240 live points at every
           size: us an iteration, ROUNDS_MIN_SHARE's source);
  phase 8  the SLAM back end: SlamPipeline at its default capacities with
           loop closure on (default Params), 60 scans 0.7 s apart around a
           3 m circle that closes after 41.9 s, skewed by the motion,
           deskewed and guessed from the IMU alone (no odometry), counted:
           6 fetches of K=16 and 3 rounds_gn a registration step, 0 GN
           rounds; the fetches of the first 3 registration steps bitwise
           equal to their plain versions; steps 0-3 within 1e-4 of the same
           steps on the CPU; register_scan_with_params on those steps' local maps and
           guesses within 3e-3 m / rad of grid_register_step; >= 1 loop
           closure accepted (ICP fitness < 0.3), the full graph solved;
           relative displacements within 0.12 m and ATE < 0.1 m of the
           truth in the first scan's frame; save_map ->
           GlobalMap.from_pcd_dir -> one LocalizationPipeline.step
           relocalizing a keyframe's scan within 0.06 m of its pose; step
           time and its split (synchronized host clock), the frontend's
           split with the picking on the kernel and on its plain
           version, the window and
           full LM, ICP ms and iterations, host syncs a step (the CUDA
           sync debug mode), a profiled window LM solve, the knn
           selection against a stable sort, the caps the step reported,
           each table's kind, rows and bytes; ICP
           counted (one icp launch a run, no knn launch in the steps) and
           every ICP run of the run again on the kernel and on the
           parent's loop (icp_align_reference on the card) in turns, ms a
           run and iterations on each; the exact solver counted (one
           exact_gn launch a solve, no knn launch, 0 host syncs inside a
           solve by the sync debug mode) and each solve again on the
           kernel and on its plain loop (exact_gn_reference on the card)
           in turns, ms a solve, iterations, n_corr and flags equal (the
           plain loop's first surf-map k-NN call kept for
           `probe knn` (c), its knn launches counted); the
           pose-graph LM counted: every optimize_pose_graph call on the
           pose_graph_lm kernel (route A: one launch; route B: two an
           iteration), the marginals' factor blocks on its blocks entry;
           every solve of the run again on the kernel and on the parent's
           loop (optimize_pose_graph_reference on the card) in turns, the
           LM's ms a step on each; every grid_register_step call (tables +
           solve) again with rounds_gn at the rule's cluster size and at
           one CTA a lane in turns, ms a step on each and a profiled
           call's device-busy share;
  phase 9  the LIO mode (examples/run.py --mode lio): LioTopology(Params(
           pose_cov_threshold=0), max_keyframes=256, imu_window=16,
           imu_max_samples=64) over 50 scans 0.2 s apart along
           constant_twist_platform (1.2 m/s, 0.15 rad/s; the raw
           sensor-frame 100 Hz IMU with quaternions in batches, each scan
           skewed by the motion) and a 1 Hz ENU GPS stream (the truth under
           a 0.6 rad yaw offset, 0.05 m noise) through EkfGps and
           NavsatTransform into SlamPipeline.add_gps, counted: 6 fetches
           of K=16 and 3 rounds_gn a registration step, 0 GN rounds; the
           fetches of the
           first 3 registration steps bitwise equal to their plain
           versions; steps 0-3 and the IMU-rate odometry up to them within
           1e-4 of the same run on the CPU; >= 2 IMU window resets through
           the float64 marginal, no failure reset, >= 1 GPS factor;
           relative displacements within 0.12 m, max translation error <
           0.15 m, the IMU-rate odometry within a median 0.05 m of the LIO
           trajectory that corrects it (against the truth printed); the
           SLAM state saved after step 20, loaded into a fresh
           SlamPipeline on the card and run 5 steps: bitwise or within
           1e-5 of the uninterrupted run; the step time and its split,
           one preintegration's and one chain LM's device operations and
           ms, host syncs a step, a profiled ImuOdometry correction, each
           table's kind, rows and bytes, the caps reported; the pose-graph
           LM counted and timed in turns as in phase 8; the IMU odometry's
           kernels counted: one imu_chain_lm and one preintegrate launch a
           correction (none at the initialization), one imu_chain_blocks a
           window reset's marginal, one propagate_states a flush and a
           re-propagation; every correction's chain solve again on the
           kernel and on the parent's loop (optimize_imu_chain_reference
           on the card) in turns, the chain LM's ms a step on each; the
           tables + solve stage in turns at rounds_gn's two cluster sizes
           as in phase 8;
  phase 10 the KITTI and multi-session entry points: (a) load_scan and
           iter_scans on the three HDL-64 scans of tests/data/kitti_mini
           bitwise equal to native.kitti_read_bin, their strict features
           at run_kitti_slam's HDL-64 Params card == CPU; (b)
           examples/run_kitti_slam.py on the drive io/kitti_drive
           generates (40 motion-skewed VLP-16 scans, radius 4 m, 1.5 m/s,
           0.1 s) with --gps --navsat --pose-cov-threshold 0, counted: 6
           K=16 fetches and 3 rounds_gn a registration step, 0 GN rounds,
           the first 3
           steps' fetches bitwise; ATE against the oxts track < 0.2 m and
           the GPS factors the CPU rehearsal gives (0); the step time and
           its split; the pose-graph LM counted and timed in turns as in
           phase 8; (c) examples/run_kitti.py's pair alignment (FPFH +
           RANSAC + ICP) on the drive's first 6 scans: the first pair's
           stages card against CPU (FPFH within 1e-5 where no histogram
           bin flipped, RANSAC on the same triplets and ICP within 1e-4),
           the chained ATE beside standing still's, ms a pair and its
           split; (d) examples/run_multisession.py:
           two 10-scan SLAM sessions, merge_sessions(coarse=False,
           link_radius=8, link_stride=1) counted (6 K=16 fetches and 3
           rounds_gn a link, the
           first 2 links' fetches bitwise; each link's fetch kinds and its
           queries near the grid's lower faces), >= 2 links, the merged map
           saved and loaded, a held-out scan localized within 0.06 m, the
           merge on the CPU within 1e-3 (each link's GN stops within its
           5e-4 m convergence step), the joint graph one pose_graph_lm
           launch, the CPU's joint graph solved on the card within 1e-5;
           align_sessions(coarse=True) over 8 generator seeds (at least
           one within 0.3 m / 0.02 rad of the known offset, ICP alone
           too), timed stage by stage, profiled, its host syncs counted;
           the k-NN and ICP kernels counted in (b) (none without --loop),
           (c) (2 knn and 1 icp a pair: FPFH of both clouds, the
           refinement) and (d)'s merge (1 icp, no knn);
  probes   `probe pose_graph_lm` lines (after phase 10): the pose-graph
           LM on the card (optimize_pose_graph: the kernel, its route by
           the live count) against its plain version on the card at (a)
           phase 8's last window graph, (b) phase 8's first full graph (a
           loop closure, 512 slots), (c) route B at 200 live poses in 512
           slots and at the cap + 1 (tests/pose_graph_scenes.py), (d) the
           edge graphs: gimbal lock and a rotation error near pi about an
           axis (H not finite: the poses bitwise unchanged), a window
           chain with GPS factors, 38 live poses with a between from pose
           0 to each (the envelope's widest), route B with its
           factorization reported failed (rejected); each with kernel ms
           (CUDA events), the solve's host wall, plain ms, launches,
           route, route A's block columns on warp 0 and on the CTA,
           bound, pose |diff| (<= 1e-4), cost rel diff (<= 1e-4),
           agreeing accepts and two launches bitwise; at (a), (b) and the
           star a `... split` line: the clock64 stages of an iteration
           (the Jacobian columns, the rest of the assembly, scale and
           damp, Cholesky with the forward solve, backward solve, new
           cost) from the diagnostic build
           (-DFBPR_LM_PROFILE, lm_builds); `probe
           pose_graph_blocks` lines: the factor blocks at random rotations,
           identity, near pi and near pi about an axis, NaN in the plain
           version's places and the rest within 1e-5;
           `probe imu_chain_lm` lines: the IMU chain LM on the card
           (optimize_imu_chain: the kernel) against its plain version on
           the card at (a) phase 9's last full window (K 16), (b) its first
           correction after a window reset (2 live), (c) K 100 (the
           reference's reset interval), (d) tests/imu_chain_scenes.py's
           scenes (an
           interior masked state, a state without a preintegration, K 1, a
           NaN interval covariance and a near-pi pose error about an axis:
           every step rejected, the states bitwise; pitch pi/2, roll
           across pi, dbg 0 and not 0); each with kernel ms (CUDA events),
           plain ms, bound, states |diff| (<= 1e-4, NaN in the same
           places), the cost's relative difference (<= 1e-3; the plain
           cost at the kernel's states within 1e-4), accepts and two
           launches bitwise; at (a) and (c) a `... split` line (eval_column,
           assemble, scale and damp, block Cholesky with the forward
           solve, backward solve, chain cost); `probe imu_chain_blocks`
           (non-finite entries
           in the same places, the rest within 1e-4 of the block's
           largest, both beside the float64 blocks); `probe preintegrate`
           and `probe propagate_states` at phase 9's interval and stream,
           a 64-sample capped interval and a 1024-sample buffer with
           interior masked samples (the leaves within 1e-6 of max(1,
           largest), cov rtol 1e-5 with a floor of 1e-7 of its largest;
           above 64 live samples 1e-5 and a floor of 1e-6, where the kernel
           is as near the float64 plain version as the plain version,
           within a factor of 2; R, p, v within 1e-5), each beside its
           plain version and bound, two launches bitwise, its launch on
           the device alone (in a CUDA graph: the host's ~0.03 ms a ctypes
           launch left out) and the clock64 split of the diagnostic build
           (-DFBPR_PREINT_PROFILE: each warp role's busy us, the cov warp's
           cycles a live sample and its step at two stamps; the
           propagation's walking warp's cycles a slot); phase 9's recorded
           preintegrate and propagate_states calls again on their launches
           alone (`time phase 9 preintegration + propagation`, ms a LIO
           step);
           `probe knn` lines: the k-NN kernel (knn on the card, one
           knn_stream launch) against its plain version on the card
           (knn_reference) at (a) ICP's phase 8 shape (the accepted loop
           candidates' source against their submap, k 1), (b) FPFH's (the
           first pair of phase 10 (c): its target cloud in itself, k 16),
           (c) the exact solver's surf map (phase 8's first checked
           registration, k 5): no-neighbour slots exact, d2 within 1e-6
           of the terms the formula cancels, index swaps only at near-ties,
           two launches bitwise, the launch and the call timed beside the
           plain version and the bound, the build with FMA contraction
           beside; `probe exact_gn` lines: the exact solver's kernel
           (exact_gn, one launch a solve) against its plain loop on the
           card (exact_gn_reference) at (a) phase 8's three solves, (b)
           batch_register on the bench batch's first 32 scans (one launch,
           ate_vs_oracle_m on its first 8 lanes <= 1e-3), (c) the bench's
           scan 0 on a surf map of 65536 slots, every one live: kernel and
           plain ms, the bound (map slots x 16 B, 2*3*Q*M operations a
           lane-iteration) and its share, iterations, n_corr and flags
           equal (at (a) on every lane; elsewhere the lanes that differ
           counted and held to the plain loop's card-vs-CPU spread on
           them or one sub-threshold GN step), pose within EXACT_TOL 1e-4
           (set from the card's readings; 1e-3 on degenerate lanes), at
           (b) and (c) or twice the plain loop's own card-vs-CPU spread
           (its CPU run on (a)'s lanes, (b)'s lanes 0 and 1, (c)'s lane)
           where larger, the first iteration's neighbours (the kernel's
           diagnostic output) bit for bit knn's (no index swap, d2 |diff|
           0), two launches bitwise; `probe icp` lines: the ICP kernel (icp_align, one
           cooperative launch) against its plain version on the card
           (icp_align_reference) and on the CPU at (a) phase 8's accepted
           loop candidates, (b) phase 10 (c)'s first pair, (c) phase 10
           (d)'s merge: transform within 1e-4 (or twice the plain
           version's own card-vs-CPU spread), converged and the fitness
           gate equal, fitness within tests/icp_scenes.fitness_tol, two
           launches bitwise, iterations of each, ms beside the bound, the
           FMA build beside, the clock64 split of a trip (icp.cu's
           diagnostic build: the 1-NN, C, M, H, S, the grid barriers,
           grid_sums) and the bound of the keys the cell search computed;
  phase 11 the sharded solvers and the XLA solver variants at the bench's
           width: (a) shard_register_tables(make_mesh("cuda"),
           solver="fused") on a one-rank NCCL group (a FileStore), on the
           raw and on the resident tables, counted (4 fetches and 2 GN
           rounds a call), bitwise equal to batch_register_fused on the
           same inputs, n_total 256, timed beside it; (b)
           map_sharded_register_tables on a one-rank ("data", "map") mesh
           with build_sharded_block_tables(S=1), whose table must be
           build_map_planar_tables', counted (4 block_fetch, 2 rounds_gn),
           bitwise
           equal to batch_register_pallas on those tables; (c) four
           striped shards' block_fetch calls on phase 1's round-1 surf
           queries merged by merge_topk: bitwise equal to the plain
           fetches' merge (the share of queries whose d2 equal the
           replicated table's printed); (d) batch_register_rounds (the
           octant-sentinel fetch) and batch_register_fast_grid (packed
           1 m tables, cap 48) at B=256 and batch_register_fast (the
           streamed prefetch, chunk 1024) at B=32, plain PyTorch but
           batch_register_rounds' rounds on rounds_gn (counted: 2; timed
           too with them on the parent's loop): ATE
           against the oracle (<= 1e-3 m; both prefetch solves <= 4e-3 m,
           the bound of tests/test_register.py) and each oracle scan's
           error, ms a scan of one call by CUDA events, peak memory, the
           difference from phase 6's poses; the fast-grid solve of the
           oracle scans on the CPU beside the card's;
           (e) dryrun_multichip(1, backend="nccl"): one spawned rank
           running every sharded stage on the card.

    python3 chip_smoke.py --gn-ab NAME=path/to/gn_round.cu ...

also builds each named GN source (same C entry point, same flags), runs it
through the shipped wrapper, and prints its ptxas lines, its pose
difference from the plain version and the same GN timing and probe lines
beside the shipped kernel's, in this one call (cards of one model differ by
up to 13% between calls).

    python3 chip_smoke.py --lm-ab DIR

also builds DIR's pose_graph_lm.cu and imu_chain_lm.cu (another version of
the two LM kernels with the same C entry points, and the headers they
include; a copy of a parent commit's, say), plain and with
-DFBPR_LM_PROFILE, and prints beside every route-A `probe pose_graph_lm`
line and every `probe imu_chain_lm` line a `... in turns` line (the
shipped kernel and DIR's in turns, shipped, other, other, shipped, by CUDA
events, and whether their outputs are bit for bit equal) and, at the split
probes, DIR's split too; phases 8 and 9 replay their LM solves on DIR's
kernel as well (`... LM in turns` lines, `other kernel` ms a step).

    python3 chip_smoke.py --knn-icp-ab DIR

also builds DIR's knn_stream.cu and icp.cu (another version of the k-NN and
ICP kernels with the same C entry points, and the headers they include),
plain and with -DFBPR_ICP_PROFILE where its icp.cu has the stamps, and
runs every `probe knn` and `probe icp` call, the GPU tests' k-NN and ICP
scenes and phase 8's ICP runs on both versions in turns, bit for bit (a
difference fails the run), with DIR's ICP split beside the shipped one's.
The knn and ICP probes' inputs are kept in build/knn_icp_inputs.pt for
scripts/knn_icp_turns.py.

    python3 chip_smoke.py --imu-ab DIR

also builds DIR's preintegration.cu (another version of the IMU
preintegration and propagation kernels with the same C entry points, and
the headers it includes) and runs every `probe preintegrate` and `probe
propagate_states` call in turns with the shipped kernels (in CUDA graphs),
phase 9's recorded preintegrate and propagate_states calls (ms a LIO step
on each) and tests/imu_chain_scenes.py's buffers and edge buffers (the GPU
tests'), bit for bit (a difference fails the run).
scripts/imu_turns.py runs the buffers alone against other versions.

Any failure raises (exit code 1).  Prints the card's name and power limit
early, a JSON line of per-kernel results second to last, and as the last
line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import glob
import json
import os
import re
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
B = 256
CCAP, SCAP = 32, 48
R1S, R1C = 8, 4          # round-0 strides (surf, corner)
K = 8
ITERS = 15
N_ORACLE = 8
PARITY_BUDGET = 1e-3     # m, bench.py's BENCH_PARITY_BUDGET
N_BLOCKS = 32            # scans of phase 6's plain-fetch comparison
# share of lanes whose GN iteration count and n_corr must equal the plain
# version's: FMA contraction may move a lane across the convergence test
# (and then its last n_corr), but a point dropped or counted twice changes
# n_corr on nearly every lane
GN_EQUAL_LANES = 0.95
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
FP32_OPS_PER_S = 67e12      # H100 SXM, fp32 outside the tensor cores
# operations per slot of a live query's row: 3 sub, 3 mul, 2 add for d2 and
# at least one compare to select from it
FETCH_OPS_PER_SLOT = 9
# operations per valid feature and GN iteration, counted from the plain
# version (ops/gn_round.py) at K=8: transform 18, d2 64, 5-of-K selection
# 120, J row and J*J^T 120, plus the fit (line ~270, Householder plane ~560)
GN_OPS_PER_POINT = {"corner": 600, "surf": 900}
# rounds_gn against its plain version on the card: pose (m / rad) and matP
# on every lane whose flags, iterations and n_corr agree; a degenerate lane
# (float32 eigenvectors of a near-degenerate JtJ turn) within ROUNDS_DEG_TOL
# (rounds_probe: where the plain version misses these against itself on
# the CPU, the kernel is held to that spread)
ROUNDS_TOL = 1e-5
ROUNDS_DEG_TOL = 1e-3
N_LOC = 20               # phase 7: localization steps
LOC_SPACING = 0.2        # s between scans (constant_twist_platform)
LOC_CHECKED = 3          # steps held against the plain fetch and the CPU
LOC_K = 16               # candidates per fetch of grid_register_step
# phase 7 (g): tests/test_torch_register_fast.py's scene, the grid's lower x
# face 0.5 m behind the room's x = -25 m wall
LF_POSE_GT = np.array([0.0, 0.0, 0.25, 2.0, -1.0, 0.0], np.float32)
LF_GUESS = LF_POSE_GT + np.array([0.015, -0.01, 0.04, 0.3, -0.25, 0.1],
                                 np.float32)
LF_HALF = (25.8, 30.0, 10.0)
# phase 7 (h): phase 7's first steps on an undownsampled map, its surf
# points at 0.2 m (finer than the 0.4 m surf leaf), cropped at the HDL-64
# surf cap of examples/run_kitti_slam.py: the step's surf table stays raw
N_DENSE = 10
DENSE_SURF_SPACING = 0.2
DENSE_SURF_CAP = 131072
DENSE_W = 512            # slots a row of that surf table holds
# (h) card vs CPU at the reference's settings: on the 0.2 m lattice ~1% of
# the surf features' 5-NN are collinear, and the plane fit's rank gate
# (|r00 r11 r22| > 1e-5, the JAX package's) passes some of them on rounding
# noise, with a noise normal; the card's and the CPU's roundings differ, so
# a step moves by up to ~4e-4 m (ROADMAP Queue 3).  With those fits
# rejected (surf_min_planar_spread = DENSE_SPREAD) the steps are held to
# 1e-4.
DENSE_CPU_TOL = 1e-3
DENSE_SPREAD = 0.01      # m: rejects collinear 5-NN only (the lattice: 0.2)
N_SLAM = 60              # phase 8: SLAM steps, one loop of the circle
SLAM_SPACING = 0.7       # s between scans
SLAM_SPEED = 0.45        # m/s: a 3 m circle at SLAM_YAW_RATE
SLAM_YAW_RATE = 0.15     # rad/s: the loop closes after 41.9 s
SLAM_CHECKED = 3         # registration steps held against plain/CPU/exact
N_LIO = 50               # phase 9: LIO steps (examples/run.py --mode lio)
LIO_SPACING = 0.2        # s between scans
LIO_CHECKED = 3          # registration steps held against the plain fetch
LIO_CPU = 4              # emitted steps held against the same run on the CPU
LIO_CKPT = 20            # steps before the checkpoint of the resume check
LIO_RESUMED = 5          # steps run from the checkpoint
LIO_PROFILED = 30        # profiled: the first full correction from this step
GPS_YAW_OFFSET = 0.6     # rad, the map frame's yaw in the ENU frame
GPS_NOISE = 0.05         # m, isotropic, of the 1 Hz ENU fixes
N_KITTI = 40             # phase 10 (b): scans of the generated drive
KITTI_CHECKED = 3        # registration steps held against the plain fetch
KITTI_ATE_BOUND = 0.2    # m, (b)'s ATE vs oxts (CPU rehearsal 0.157)
KITTI_GPS_FACTORS = 0    # (b)'s GPS factors, as the CPU rehearsal gives
KITTI_PAIRS = 6          # phase 10 (c): scans of the pair alignment
N_MS = 10                # phase 10 (d): SLAM steps of each session
MS_CHECKED = 2           # link registrations held against the plain fetch
ALIGN_DRAWS = 8          # generator seeds of (d)'s coarse align_sessions
# (d) card vs CPU, the whole merge: a link's GN stops at the first step
# under its 5e-4 m convergence threshold, and float noise can move that stop
# by an iteration (2.9e-4 m measured on the card; ROADMAP Queue 3)
MERGE_TOL = 1e-3
N_FAST = 32              # phase 11 (d): scans of batch_register_fast
# m, the oracle gate of both prefetch solves (fast and fast-grid): the JAX
# package's own bound for the prefetch solve (tests/test_register.py:164-166).
# Both miss the bench's 1e-3 on these scans: each stops on scan 5 after 5
# iterations 5.0e-3 / 5.4e-3 m from the oracle (the rounds solve 5e-6),
# the same on the CPU (PERF.md, ROADMAP Queue 3)
FAST_BUDGET = 4e-3
FAST_CHUNK = 1024        # its streamed k-NN chunk (bounds the [B,Q,C] d2)
FAST_GRID_CAP = 48       # phase 11 (d): cell cap of the packed 1 m tables
# (d): at least one draw within this (m, rotation) of the known offset: the
# basin of ICP alone, 0.184 m off on the CPU in both packages (PERF.md)
ALIGN_BOUND = (0.3, 0.02)
# operations of the streamed k-NN a (query, live map point) pair: q . m (3
# multiplies, 2 adds) and (|q|^2 + |m|^2) - 2 q.m (3)
KNN_OPS_PAIR = 8
# operations of ICP a source row and trip besides its pairs: T src (9
# multiplies, 9 adds), the centroid's sum (3), the weights' sums (2), the
# centroids (6 multiplies, 6 adds), H ((s - mu) wn: 3 + 3, nn - mu: 3, the
# outer product's 9 multiplies and 9 adds)
ICP_OPS_ROW = 18 + 3 + 2 + 12 + 27
ICP_TOL = 1e-4           # m / rad: icp.cu's transform against its plain version


def tpu_kernel_line(file_name, kernel):
    """'path:line' in this checkout of the Pallas kernel a CUDA kernel
    replaces (searched for, so the reported line is the real one)."""
    for path in sorted(glob.glob(os.path.join(REPO, "*", "ops", file_name))):
        with open(path) as f:
            for n, line in enumerate(f, 1):
                if line.startswith(f"def {kernel}("):
                    return f"{os.path.relpath(path, REPO)}:{n}"
    raise FileNotFoundError(f"{kernel} in */ops/{file_name}")


def xla_loop_line(file_name, text, sub="ops"):
    """'path:line' in this checkout of the first line of */<sub>/<file_name>
    that holds `text`: the JAX device loop a kernel replaces."""
    for path in sorted(glob.glob(os.path.join(REPO, "*", sub, file_name))):
        with open(path) as f:
            for n, line in enumerate(f, 1):
                if text in line:
                    return f"{os.path.relpath(path, REPO)}:{n}"
    raise FileNotFoundError(f"{text} in */{sub}/{file_name}")


def print_ptxas(src, log, only=None):
    """The registers, stack and spill lines of ptxas -v, each with the
    kernel and template arguments (K first) it belongs to; only: the
    kernel instances to print (all by default)."""
    fn = "?"
    with open(log) as f:
        for line in f:
            m = re.search(r"entry function '\w*?([a-z_]+_kernel)"
                          r"(?:I((?:L[ib]\d+E)+))?", line)
            if m and m.group(2):
                args = ",".join(re.findall(r"\d+", m.group(2)))
                fn = f"{m.group(1)}<{args}>"
            elif m:
                fn = m.group(1)
            elif ("registers" in line or "spill" in line) and (
                    only is None or fn in only):
                print(f"ptxas {src} {fn}: {line.strip()}", flush=True)


def gn_variants(named_sources):
    """{name: call(args, iters, K=K, **kw) -> (stat', matP')} for other GN
    sources with the shipped C entry point, built like the shipped ones
    (one nvcc each, all at once), for A/B readings in this run.  A call
    runs the shipped wrapper ops.gn_round.gn_round (its checks and
    defaults) with its launch pointed at the other build."""
    from feature_base_pointcloud_registration_tpu_torch import kernels
    from feature_base_pointcloud_registration_tpu_torch.ops.gn_round import (
        gn_round)
    sos = kernels._build([Path(src).resolve() for _, src in named_sources])
    shipped = kernels.launch_gn_round
    calls = {}
    for (name, _), so in zip(named_sources, sos):
        print_ptxas(name, kernels.BUILD_DIR / (so.stem + ".log"))
        launch = functools.partial(shipped, lib=kernels.load(so))

        def call(args, iters, K=K, launch=launch, **kw):
            kernels.launch_gn_round = launch
            try:
                return gn_round(*args, K=K, iters=iters, **kw)
            finally:
                kernels.launch_gn_round = shipped
        calls[name] = call
    return calls


def live_only(args):
    """The GN inputs with each lane's live features (and their candidates)
    packed to the front and P cut to the batch's largest live count."""
    import torch
    stat, matP, fc, fs, cc, cs = args
    B = stat.shape[0]
    out = []
    for f, c in ((fc, cc), (fs, cs)):
        live = f[:, 3] != 0
        n = max(int(live.sum(1).max()), 1)
        order = torch.sort((~live).to(torch.int8), dim=1,
                           stable=True).indices[:, :n]
        out.append(torch.gather(f, 2, order[:, None].expand(-1, 4, -1))
                   .contiguous())
        out.append(torch.gather(c.view(3 * K, B, -1), 2,
                                order[None].expand(3 * K, -1, -1))
                   .reshape(3 * K, B * n).contiguous())
    return stat, matP, out[0], out[2], out[1], out[3]


def first_lanes(args, n):
    """The GN inputs of the first n lanes."""
    stat, matP, fc, fs, cc, cs = args
    B = stat.shape[0]

    def cut(c):
        return c.view(3 * K, B, -1)[:, :n].reshape(3 * K, -1).contiguous()
    return (stat[:n].contiguous(), matP[:n].contiguous(),
            fc[:n].contiguous(), fs[:n].contiguous(), cut(cc), cut(cs))


def gn_probes(name, call, rounds, n_sm, other_k):
    """Probe lines of one GN kernel at both rounds' inputs: ms per call for
    (a) the inputs as they are (with the histogram of per-lane iterations
    and us per lane-iteration), (b) convergence thresholds 0, so every
    valid lane runs exactly 1 or ITERS iterations, (c) live features only,
    (d) one lane per SM against all B lanes, (e) round 0 only (its lanes
    are at iteration 0): one iteration with the 6-sweep Jacobi against
    none, which prices the Jacobi; (f) round 1's inputs with the
    candidates of the other supported K (other_k = {K: args})."""
    import torch
    for r, args in enumerate(rounds):
        B = args[0].shape[0]
        ms = cuda_ms(lambda: call(args, ITERS), 10, graph=True)
        its = (call(args, ITERS)[0][:, 6] - args[0][:, 6]).long()
        hist = torch.bincount(its, minlength=ITERS + 1).tolist()
        print(f"probe gn {name} (a) round {r}: {ms:.4f} ms; lane-iterations"
              f" {int(its.sum())}, {ms * 1e3 / max(int(its.sum()), 1):.4f} "
              f"us each; iterations histogram (0..{ITERS}) {hist}",
              flush=True)
        fixed = [cuda_ms(lambda: call(args, n, conv_rot_deg=0.0,
                                      conv_trans_cm=0.0), 10, graph=True)
                 for n in (1, ITERS)]
        print(f"probe gn {name} (b) round {r}: iters 1 {fixed[0]:.4f} ms, "
              f"iters {ITERS} {fixed[1]:.4f} ms; "
              f"{(fixed[1] - fixed[0]) / (ITERS - 1):.4f} ms an iteration",
              flush=True)
        packed = live_only(args)
        ms_c = cuda_ms(lambda: call(packed, ITERS), 10, graph=True)
        print(f"probe gn {name} (c) round {r}: {ms_c:.4f} ms at Pc "
              f"{packed[2].shape[2]} Ps {packed[3].shape[2]} (from "
              f"{args[2].shape[2]} / {args[3].shape[2]})", flush=True)
        few = first_lanes(args, n_sm)
        ms_d = cuda_ms(lambda: call(few, ITERS), 10, graph=True)
        print(f"probe gn {name} (d) round {r}: B={n_sm} {ms_d:.4f} ms, "
              f"B={B} {ms:.4f} ms", flush=True)
        if r == 0:
            sweeps = [cuda_ms(lambda: call(args, 1, jacobi_sweeps=n), 10,
                              graph=True) for n in (6, 0)]
            print(f"probe gn {name} (e) round 0: iters 1 with the Jacobi "
                  f"{sweeps[0]:.4f} ms, without {sweeps[1]:.4f} ms",
                  flush=True)
    for k, args in other_k.items():
        ms = cuda_ms(lambda: call(args, ITERS, K=k), 10, graph=True)
        print(f"probe gn {name} (f) round 1 K={k}: {ms:.4f} ms", flush=True)


def cuda_ms(fn, reps, graph=False):
    """Mean device ms per call of fn over reps calls (after one warm-up).
    graph=True captures the reps calls in a CUDA graph and times one
    replay, so that a call shorter than its host-side launch (a GN round
    of one iteration) is timed on the device alone; fn must then not
    synchronize (the kernels' wrappers do not, the plain versions do)."""
    import torch
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(reps):
                fn()
        g.replay()
        torch.cuda.synchronize()
        start.record()
        g.replay()
    else:
        start.record()
        for _ in range(reps):
            fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes, ops):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the fp32 rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def gn_bound(args, stat_out, K):
    """(bound_ms, bound_by, floor_ms) of one GN round on args = (stat,
    matP, featc, feats, candc, cands), or rounds_gn's (the same and the d2
    planes cd2, sd2, read for live points), that ended at stat_out: read once,
    the mask of every point and the xyz and candidates of each live one (a
    dead point's add nothing, so the kernel never reads them), stat/matP
    read and written; operations for the lane-iterations this run's data
    took.  floor_ms: the candidates and features of every live point
    streamed once per lane-iteration."""
    stat, _, fc, fs = args[:4]
    B = stat.shape[0]
    n_pts = fc.shape[2] + fs.shape[2]
    lane_iters = (stat_out[:, 6] - stat[:, 6]).clamp(min=0)
    live = {kind: (f[:, 3] != 0).sum(1).float()
            for kind, f in (("corner", fc), ("surf", fs))}
    n_live = float(sum(n.sum() for n in live.values()))
    ops = sum(float((lane_iters * n).sum()) * GN_OPS_PER_POINT[kind]
              for kind, n in live.items())
    per_live = 3 + 3 * K + (K if len(args) == 8 else 0)   # rounds_gn: d2
    ms, by = bound(B * n_pts * 4 + n_live * per_live * 4
                   + B * (16 + 36) * 4 * 2, ops)
    streamed = float((lane_iters * (live["corner"] + live["surf"])).sum())
    return ms, by, streamed * (16 + 12 * K) / HBM_BYTES_PER_S * 1e3


def fetch_bound(table, bcell, K):
    """Bound of one fetch call: the table rows the live queries read, each
    once (a raw table holds a row for every block of the grid, most of them
    never read), the queries (bcell, q) read once, d2 and candidates
    written once; 9 operations per slot of each live query's row."""
    import torch
    Q = bcell.shape[0]
    W = table.shape[1] // 3
    live = bcell != table.shape[0] - 1
    rows = torch.unique(bcell[live]).numel()
    nbytes = rows * 12 * W + Q * 16 + Q * K * 16
    return bound(nbytes, int(live.sum()) * W * FETCH_OPS_PER_SLOT)


def tile_rows(bcell, sentinel, tile):
    """(live queries, distinct (tile, row) pairs) of a query set cut into
    tiles of `tile` consecutive queries."""
    import torch
    q = torch.nonzero(bcell != sentinel)[:, 0]
    pairs = torch.unique((q // tile) * (sentinel + 1) + bcell[q].long())
    return q.numel(), pairs.numel()


def fetch_probes(raw_tq, rtab, presorted, queries_of):
    """Probe lines for both fetch kernels at one query set (CUDA events):
    (a) the queries as they are, (b) the same features presorted per lane,
    (c) every query at the sentinel, (d) every live query on one row; then
    K = 6/8/16 on (a).  raw_tq = (raw table, queries on raw block ids);
    rtab the same map's PlanarTable; presorted = presort_by_row's output;
    queries_of(xyz, mask) -> the queries of those features at (a)'s
    poses."""
    import torch

    from feature_base_pointcloud_registration_tpu_torch import kernels
    from feature_base_pointcloud_registration_tpu_torch.ops.fetch import (
        block_fetch, resident_fetch)
    tab, (bc, qx, qy, qz) = raw_tq
    bcb, *qb = queries_of(*presorted[:2])
    tile = kernels.FETCH_TILE
    for name, fn, table, route in (
            ("block_fetch", block_fetch, tab, lambda b: b),
            ("resident_fetch", resident_fetch, rtab.table,
             lambda b: rtab.rows_index[b.long()])):
        W = table.shape[1] // 3
        sent = table.shape[0] - 1
        a = route(bc)
        live = a != sent
        one_row = torch.where(live, a[live][0], sent).to(torch.int32)
        patterns = {"a": (a, qx, qy, qz), "b": (route(bcb), *qb),
                    "c": (torch.full_like(a, sent), qx, qy, qz),
                    "d": (one_row.contiguous(), qx, qy, qz)}
        for p, q in patterns.items():
            n_live, pairs = tile_rows(q[0], sent, tile)
            ms = cuda_ms(lambda: fn(table, *q, K=K), 20)
            print(f"probe {name} ({p}) K={K}: {ms:.4f} ms; Q {q[0].shape[0]}"
                  f" live {n_live} W {W}; tile-row pairs {pairs} (tile "
                  f"{tile}): row bytes {pairs * 12 * W} once per tile-row vs"
                  f" {n_live * 12 * W} once per query", flush=True)
        for k in (6, 8, 16):
            ms = cuda_ms(lambda: fn(table, *patterns["a"], K=k), 20)
            print(f"probe {name} (a) K={k}: {ms:.4f} ms", flush=True)


def fetch_smem(W, K):
    """Dynamic shared memory of one fetch block, bytes (csrc/fetch_tile.cuh
    TileLayout: whole rows of the row buffer, the tile's staged results,
    its queries and its ids)."""
    row = 12 * W
    nb = max(1, min(48 * 1024 // row, 128))
    return nb * row + 16 * 128 * K + 12 * 128 + 4 * (5 * 128 + 1 + 8)


def profile_call(fn):
    """(wall ms, device-busy ms, [(kernel, ms)] by device time) of one call
    under torch.profiler; busy is the union of the device events' spans
    (0 when the profiler records none)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            spans.append((e.time_range.start, e.time_range.end))
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.time_range.elapsed_us() / 1e3)
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    return wall, busy / 1e3, sorted(by_name.items(), key=lambda kv: -kv[1])


def table_info(table):
    """(kind, rows, W, bytes) of a table from build_map_planar_tables."""
    from feature_base_pointcloud_registration_tpu_torch.ops.fetch import (
        PlanarTable)
    if isinstance(table, PlanarTable):
        t = table.table
        return ("resident", t.shape[0] - 1, t.shape[1] // 3,
                t.numel() * 4 + table.rows_index.numel() * 4)
    return "raw", table.shape[0] - 1, table.shape[1] // 3, table.numel() * 4


def fetch_recorder(real_fetch_rows, calls, check):
    """A stand-in for ops.fetch.fetch_rows that records each call (table
    kind, K, W, Q) in `calls` and, while check["on"], holds it against its
    plain version on the same table (rec["equal"], rec["err"])."""
    import torch

    from feature_base_pointcloud_registration_tpu_torch.ops import (
        fetch as tfetch)

    def checked_fetch_rows(table, bcell, qx, qy, qz, *, K, planes_out=True):
        out = real_fetch_rows(table, bcell, qx, qy, qz, K=K,
                              planes_out=planes_out)
        kind, rows, W, nbytes = table_info(table)
        rec = {"kind": kind, "K": K, "Q": bcell.shape[0], "W": W,
               "rows": rows, "bytes": nbytes}
        if check["on"]:
            if kind == "resident":
                d2r, cr = tfetch.resident_fetch_reference(
                    table.table, table.rows_index[bcell.long()], qx, qy, qz,
                    K=K)
            else:
                d2r, cr = tfetch.block_fetch_reference(table, bcell, qx, qy,
                                                       qz, K=K)
            if not planes_out:
                cr = cr.view(3, K, -1).permute(2, 1, 0)
            rec["equal"] = torch.equal(out[0], d2r) and torch.equal(out[1],
                                                                     cr)
            rec["err"] = max((out[0] - d2r).abs().max().item(),
                             (out[1] - cr).abs().max().item())
        calls.append(rec)
        return out
    return checked_fetch_rows


def checked_fetches(calls):
    """(the checked calls, {kernel: max_abs_err}) of a fetch_recorder."""
    checked = [c for c in calls if "equal" in c]
    fetch_err = {}
    for c in checked:
        name = f"{'resident' if c['kind'] == 'resident' else 'block'}_fetch"
        fetch_err[name] = max(fetch_err.get(name, 0.0), c["err"])
    return checked, fetch_err


def raw_of(s, device, batch=False):
    """A simulated scan (io.synthetic.simulate_scan's dict) as a RawScan on
    `device`, with a batch dim of 1 when `batch`."""
    import torch

    from feature_base_pointcloud_registration_tpu_torch.pipeline.cloud_info import (  # noqa: E501
        RawScan)
    raw = RawScan.from_numpy(
        s["xyz"], s["intensity"], s["ring"], s["time"],
        device=device)._replace(valid=torch.from_numpy(s["valid"]).to(device))
    return RawScan(*(a[None] for a in raw)) if batch else raw


def step_split(params, gm, runs):
    """Mean device ms of a localization step's stages (frontend, crop,
    tables, solve; CUDA events) over runs = [(scan, deskew table,
    previous pose)] on gm's device, the step's calls made one by one:
    tables is grid_register_step up to its register_rounds_core call,
    solve that call."""
    import torch

    from feature_base_pointcloud_registration_tpu_torch.ops import (
        register as treg)
    from feature_base_pointcloud_registration_tpu_torch.pipeline.cloud_info import (  # noqa: E501
        DeskewInfo)
    from feature_base_pointcloud_registration_tpu_torch.pipeline.frontend import (  # noqa: E501
        process_scan)
    from feature_base_pointcloud_registration_tpu_torch.pipeline.localization import (  # noqa: E501
        _crop_local_map)

    dev = gm.surf_xyz.device
    he, rhe = params.local_map_half_extent, params.register_grid_half_extent
    real_solve = treg.register_rounds_core
    split = np.zeros(4)
    for s, dsk_cpu, prev in runs:
        raw = raw_of(s, dev, batch=True)
        dsk = DeskewInfo(*(a.to(dev) for a in dsk_cpu))
        guess = torch.from_numpy(prev[None]).to(dev)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]

        def solve(*a, **kw):
            ev[3].record()
            return real_solve(*a, **kw)

        torch.cuda.synchronize()
        ev[0].record()
        _, feats = process_scan(params, raw, dsk)
        ev[1].record()
        lmap, _ = _crop_local_map(gm.corner_xyz, gm.corner_mask,
                                  gm.surf_xyz, gm.surf_mask, guess[0, 3:6],
                                  half_extent=he,
                                  map_corner_cap=params.map_corner_cap,
                                  map_surf_cap=params.map_surf_cap)
        ev[2].record()
        treg.register_rounds_core = solve
        try:
            treg.grid_register_step(lmap, feats, guess, half_extent=rhe)
        finally:
            treg.register_rounds_core = real_solve
        ev[4].record()
        torch.cuda.synchronize()
        split += [ev[i].elapsed_time(ev[i + 1]) for i in range(4)]
    return split / len(runs)


@contextlib.contextmanager
def plain_picking():
    """Inside the block the picking runs its plain version on any device
    (ops/features.py::ring_pick_reference: the MIS rounds driven from the
    host, one sync a round, the route before the ring-pick kernel), so one
    call times the kernel against the parent's route."""
    from feature_base_pointcloud_registration_tpu_torch.ops import features
    kernel = features.ring_pick
    features.ring_pick = features.ring_pick_reference
    try:
        yield
    finally:
        features.ring_pick = kernel


def ring_pick_wrapper():
    """ops/features.py's ring_pick, whose `launches` the phases count."""
    from feature_base_pointcloud_registration_tpu_torch.ops.features import (
        ring_pick)
    return ring_pick


def picking_route(route):
    return plain_picking() if route == "plain" else contextlib.nullcontext()


@contextlib.contextmanager
def plain_rounds():
    """Inside the block the rounds solver's iterations run their plain
    version on any device (ops/rounds_gn.py::rounds_gn_reference: the
    port's loop body, driven from the host with one sync an iteration, the
    route before the rounds_gn kernel), so one call times the kernel
    against the parent's route."""
    from feature_base_pointcloud_registration_tpu_torch.ops import (
        register as treg, rounds_gn as trounds)
    kernel = treg.rounds_gn
    treg.rounds_gn = trounds.rounds_gn_reference
    try:
        yield
    finally:
        treg.rounds_gn = kernel


def rounds_route(route):
    return plain_rounds() if route == "plain" else contextlib.nullcontext()


def rounds_gn_wrapper():
    """ops/rounds_gn.py's rounds_gn, whose `launches` the phases count."""
    from feature_base_pointcloud_registration_tpu_torch.ops.rounds_gn import (
        rounds_gn)
    return rounds_gn


class LaunchCount:
    """A launch counter kept as an attribute of a wrapper under another name
    (route B's, the factor blocks'), read and set as `launches`."""

    def __init__(self, fn, attr):
        self.fn, self.attr = fn, attr

    @property
    def launches(self):
        return getattr(self.fn, self.attr)

    @launches.setter
    def launches(self, value):
        setattr(self.fn, self.attr, value)


def pose_graph_counters():
    """{name: counter} of graph/pose_graph.py's kernel launches: route A's
    (fbpr_pose_graph_lm, one a solve), route B's (assemble and update, two
    an iteration), the factor blocks' (fbpr_pose_graph_blocks)."""
    from feature_base_pointcloud_registration_tpu_torch.graph import (
        pose_graph as tpg)
    return {"pose_graph_lm": LaunchCount(tpg.optimize_pose_graph,
                                         "launches"),
            "pose_graph_lm_b": LaunchCount(tpg.optimize_pose_graph,
                                           "launches_b"),
            "pose_graph_blocks": LaunchCount(tpg.graph_factor_blocks,
                                             "launches")}


def lm_route_recorder(fn, routes):
    """fn (an optimize_pose_graph) appending each call's route to routes:
    "A" (one route-A launch) or "B" (two route-B launches an iteration);
    a call that launched neither raises."""
    from feature_base_pointcloud_registration_tpu_torch.graph import (
        pose_graph as tpg)
    opg = tpg.optimize_pose_graph

    def recorded(g, *a, **kw):
        a0, b0 = opg.launches, opg.launches_b
        out = fn(g, *a, **kw)
        da, db = opg.launches - a0, opg.launches_b - b0
        its = kw.get("iterations", a[0] if a else 10)
        if (da, db) == (1, 0):
            routes.append("A")
        elif da == 0 and db == 2 * its:
            routes.append("B")
        else:
            raise AssertionError(f"optimize_pose_graph launched route A "
                                 f"{da}, route B {db} times")
        return out
    return recorded


def lm_routes(lm):
    """(entry point, its plain version, the size of a call's first
    argument) of the LM kernel lm: "pose_graph_lm" (optimize_pose_graph,
    poses) or "imu_chain_lm" (optimize_imu_chain, states)."""
    if lm == "pose_graph_lm":
        from feature_base_pointcloud_registration_tpu_torch.graph import (
            pose_graph as tpg)
        return (tpg.optimize_pose_graph, tpg.optimize_pose_graph_reference,
                lambda g: g.poses.shape[0])
    from feature_base_pointcloud_registration_tpu_torch.graph import (
        imu_graph as tig)
    return (tig.optimize_imu_chain, tig.optimize_imu_chain_reference,
            lambda d: d.states.shape[0])


def lm_in_turns(calls, lm):
    """Every recorded call ((args, kw, out)) of the LM kernel lm's entry
    point solved again on the kernel and on the parent's loop (its plain
    version on the card, the route before the kernel), in turns (the
    kernel first on even calls), and, given --lm-ab, on the other
    version's kernel between them: [(kernel ms, plain ms, K, plain |diff|
    of the first output from the recorded solve, other kernel ms or
    None)], host wall with the device synchronized.  The other version's
    solves add to the entry point's launch count."""
    import torch

    kernel, plain, size = lm_routes(lm)
    other = LM_AB.get("plain", {}).get(lm)
    routes = ("kernel", "other", "plain") if other else ("kernel", "plain")
    launcher = f"launch_{lm}"
    if other and calls:  # the other build's first launch loads its module
        with launching_with(launcher, other):
            kernel(*calls[0][0], **calls[0][1])
        torch.cuda.synchronize()
    out = []
    for i, (a, kw, res) in enumerate(calls):
        ms, d = {}, 0.0
        for route in (routes if i % 2 == 0 else routes[::-1]):
            fn = plain if route == "plain" else kernel
            with (launching_with(launcher, other) if route == "other"
                  else contextlib.nullcontext()):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                r = fn(*a, **kw)
                torch.cuda.synchronize()
            ms[route] = (time.perf_counter() - t0) * 1e3
            if route == "plain":
                d = float((r[0] - res[0]).abs().max())
        out.append((ms["kernel"], ms["plain"], size(a[0]), d,
                    ms.get("other")))
    return out


def print_lm_in_turns(phase, calls, steps, step_ms, lm="pose_graph_lm"):
    """The `time <phase> graph LM in turns` line (`chain LM` for
    imu_chain_lm): each recorded solve again on the kernel and on the
    parent's loop (lm_in_turns), by size, and the LM's ms a step on each
    over `steps` steps beside the step's mean `step_ms`.  Returns (kernel
    ms a step, parent's loop ms a step)."""
    turns = lm_in_turns(calls, lm)
    by_k = {}
    for k_ms, p_ms, K_, _, o_ms in turns:
        by_k.setdefault(K_, []).append((k_ms, p_ms, o_ms))
    ker = sum(t[0] for t in turns) / steps
    pla = sum(t[1] for t in turns) / steps
    oth = (sum(t[4] for t in turns) / steps
           if turns and turns[0][4] is not None else None)
    what = "graph" if lm == "pose_graph_lm" else "chain"
    print(f"time {phase} {what} LM in turns (every solve of the run again, "
          f"on the {lm} kernel" + (", on the other version's kernel "
                                   "(--lm-ab)" if oth is not None else "")
          + f" and on the parent's loop, "
          f"{lm_routes(lm)[1].__name__}, in turns): " + "; ".join(
              f"K {K_}: {len(v)} solves, kernel "
              f"{np.mean([x[0] for x in v]):.3f} ms, " + (
                  f"other kernel {np.mean([x[2] for x in v]):.3f} ms, "
                  if oth is not None else "") + f"parent's loop "
              f"{np.mean([x[1] for x in v]):.2f} ms"
              for K_, v in sorted(by_k.items())) + f"; per step kernel "
          f"{ker:.3f} ms, " + (f"other kernel {oth:.3f} ms, "
                               if oth is not None else "")
          + f"parent's loop {pla:.2f} ms (the step "
          f"{step_ms:.2f} ms on the kernel, {step_ms - ker + pla:.2f} ms "
          f"with the parent's loop in its place); the parent's loop |diff| "
          f"from the run's solves max "
          f"{max((t[3] for t in turns), default=0.0):.3e}", flush=True)
    if oth is not None:
        LM_AB.setdefault("steps", {})[f"{phase} {lm}"] = dict(
            kernel_ms_step=ker, other_ms_step=oth, step_ms=step_ms)
    return ker, pla


# the inputs of phase 8's graph solves kept for the pose_graph_lm probes
# ({name: (graph, iterations)})
LM_INPUTS = {}

# --lm-ab DIR: another version of pose_graph_lm.cu and imu_chain_lm.cu (DIR
# holds them and the headers they include; the parent's, say), built by
# lm_builds: {"plain": {stem: lib}, "profile": {stem: lib}}; the LM probes
# time it in turns against the shipped kernels and print its clock64 split
# beside theirs, phases 8 and 9 replay their solves on it too
LM_AB = {}
# the shipped kernels' diagnostic builds ({stem: lib}), built at first use
LM_PROFILE = {}

# the clock64 stages of the two LM kernels' diagnostic builds (dense_lm.cuh's
# LmProf): the prologue and epilogue once a solve, the rest an iteration
LM_STAGES = {
    "pose_graph_lm": ("prologue", "assembly", "scale and damp", "Cholesky",
                      "solves", "new cost", "epilogue", "Jacobian columns"),
    "imu_chain_lm": ("prologue", "eval_column", "assemble", "scale and damp",
                     "block Cholesky", "solves", "chain cost", "epilogue")}


def ab_builds(stems, src_dir=None, profile=None):
    """{stem: lib}: csrc/<stem>.cu for each of stems (or src_dir's, another
    version's, with the headers they include) built together, one nvcc
    each, with the shipped flags and, given profile (-DFBPR_LM_PROFILE,
    -DFBPR_ICP_PROFILE), that diagnostic build's clock64 stamps and
    fbpr_*_profile entry points; loaded, their ptxas lines printed."""
    from feature_base_pointcloud_registration_tpu_torch import kernels
    base = Path(src_dir) if src_dir else kernels.CSRC
    sos = kernels._build([base / f"{stem}.cu" for stem in stems],
                         extra_flags=[profile] if profile else [])
    what = ("other version's " if src_dir else "") + (
        "diagnostic build" if profile else "build")
    for stem, so in zip(stems, sos):
        print_ptxas(f"{stem} ({what})", kernels.BUILD_DIR / (so.stem + ".log"))
    return {stem: kernels.load(so) for stem, so in zip(stems, sos)}


def lm_builds(src_dir=None, profile=True):
    """pose_graph_lm.cu and imu_chain_lm.cu (ab_builds), with
    -DFBPR_LM_PROFILE if profile."""
    return ab_builds(tuple(LM_STAGES), src_dir,
                     "-DFBPR_LM_PROFILE" if profile else None)


def lm_launcher(lm, x, iterations):
    """launch(lib) -> (poses or states, cost, accepts): one solve of x (a
    pose graph on route A, or an IMU chain) by the build lib of lm's kernel
    (None: the shipped one), into the same output tensors each call."""
    import torch

    from feature_base_pointcloud_registration_tpu_torch import kernels
    if lm == "pose_graph_lm":
        from feature_base_pointcloud_registration_tpu_torch.graph import (
            pose_graph as tpg)
        x = tpg._contiguous(x)
        ls = tpg.live_set(x)
        first = x.poses
    else:
        from feature_base_pointcloud_registration_tpu_torch.graph import (
            imu_graph as tig)
        x = tig._contiguous(x)
        first = x.states
        scratch = torch.empty(kernels.imu_chain_floats(first.shape[0]),
                              device=first.device)
    out = torch.empty_like(first)
    cost = torch.empty((), device=first.device)
    acc = torch.zeros(iterations, dtype=torch.int32, device=first.device)

    def launch(lib):
        if lm == "pose_graph_lm":
            kernels.launch_pose_graph_lm(x, ls, iterations, out, cost, acc,
                                         lib=lib)
        else:
            kernels.launch_imu_chain_lm(x, iterations, out, cost, acc,
                                        scratch, lib=lib)
        return out, cost, acc
    return launch


def lm_split(lm, name, launch, lib, which, reps=5):
    """One `probe <lm> <name> split` line: reps solves by the diagnostic
    build lib (lm_builds) through launch (lm_launcher), and the stages of
    a solve from its clock64 sums, stamped on thread 0 after a CTA barrier
    (dense_lm.cuh's LmProf), in us an iteration (the cycles over the clock
    that the kernel's own clock64 and globaltimer give): the pose graph's
    assembly (the Jacobian columns apart; a build without that stamp
    counts them in the assembly), scale and damp, Cholesky, solves and new
    cost, the chain's
    eval_column, assemble, scale and damp, block Cholesky, solves and chain
    cost; the prologue and epilogue in us a solve.  Returns the record."""
    import ctypes

    import torch

    from feature_base_pointcloud_registration_tpu_torch import kernels
    entry = getattr(lib, f"fbpr_{lm}_profile")
    out = (ctypes.c_uint64 * 12)()
    torch.cuda.synchronize()
    kernels._check_rc(f"fbpr_{lm}_profile", entry(ctypes.addressof(out), 1))
    for _ in range(reps):
        launch(lib)
    torch.cuda.synchronize()
    kernels._check_rc(f"fbpr_{lm}_profile", entry(ctypes.addressof(out), 1))
    solves, its, *stage, cycles, ns = (int(v) for v in out)
    ghz = cycles / max(ns, 1)
    names = LM_STAGES[lm]
    us = {n: stage[i] / ghz / 1e3 for i, n in enumerate(names)}
    per_it = {n: us[n] / max(its, 1) for n in names
              if n not in ("prologue", "epilogue")}
    it_us = sum(per_it.values())
    rec = dict(iteration_us=it_us, stages_us=per_it,
               prologue_us=us["prologue"] / max(solves, 1),
               epilogue_us=us["epilogue"] / max(solves, 1),
               solve_us=ns / max(solves, 1) / 1e3, ghz=ghz,
               iterations=its / max(solves, 1))
    print(f"probe {lm} {name} split ({which}, clock64 on thread 0 after a "
          f"CTA barrier, {rec['iterations']:.0f} iterations a solve, clock "
          f"{ghz:.3f} GHz): an iteration {it_us:.2f} us = " + ", ".join(
              f"{n} {v:.2f} ({v / max(it_us, 1e-9):.1%})"
              for n, v in per_it.items()) + f"; a solve "
          f"{rec['solve_us']:.2f} us (prologue {rec['prologue_us']:.2f}, "
          f"epilogue {rec['epilogue_us']:.2f})", flush=True)
    return rec


def _same_bits(a, b):
    """Equal bit for bit, NaN in the same places counting as equal."""
    import torch
    if a.dtype.is_floating_point:
        return bool(torch.equal(a.view(torch.int32), b.view(torch.int32))
                    if a.dtype == torch.float32 else torch.equal(a, b))
    return bool(torch.equal(a, b))


def lm_turns(lm, name, launch, other, reps=20, flag="--lm-ab",
             graph=False):
    """One `probe <lm> <name> in turns` line: the shipped kernel and
    another build (other, flag's) on the same inputs, in turns (shipped,
    other, other, shipped; reps launches each by CUDA events, in a CUDA
    graph if graph), and whether their outputs (launch(lib)'s tensors) are
    bit for bit equal.  Returns the record."""
    import torch
    mine = [t.clone() for t in launch(None)]
    theirs = [t.clone() for t in launch(other)]
    torch.cuda.synchronize()
    same = all(_same_bits(a, b) for a, b in zip(mine, theirs))
    ms = {"shipped": [], "other": []}
    for route in ("shipped", "other", "other", "shipped"):
        lib = other if route == "other" else None
        ms[route].append(cuda_ms(lambda: launch(lib), reps, graph=graph))
    k, o = float(np.mean(ms["shipped"])), float(np.mean(ms["other"]))
    print(f"probe {lm} {name} in turns (the shipped kernel and the other "
          f"version's, {flag}, in turns): kernel {ms['shipped'][0]:.4f} / "
          f"{ms['shipped'][1]:.4f} ms, other {ms['other'][0]:.4f} / "
          f"{ms['other'][1]:.4f} ms: {o / k:.2f}x; outputs bit for bit "
          f"equal {same}", flush=True)
    return dict(ms=ms["shipped"], other_ms=ms["other"], speedup=o / k,
                bitwise_other=same)


def lm_extras(lm, name, launch, split):
    """The LM probes' additions, through launch (lm_launcher): the shipped
    kernel's clock64 split (if split) and, given --lm-ab, the other
    version's in turns and its split.  Returns {"split": ..., "in_turns":
    ..., "other_split": ...}."""
    rec = {}
    if split:
        if not LM_PROFILE:
            LM_PROFILE.update(lm_builds())
        rec["split"] = lm_split(lm, name, launch, LM_PROFILE[lm],
                                "diagnostic build")
    if LM_AB:
        rec["in_turns"] = lm_turns(lm, name, launch, LM_AB["plain"][lm])
        if split:
            rec["other_split"] = lm_split(
                lm, name, launch, LM_AB["profile"][lm],
                "the other version's diagnostic build")
    return rec


# the inputs of the first rounds_gn calls of a phase ({phase: [(args,
# kw), ...]}), kept for the rounds_gn probes
ROUNDS_INPUTS = {}
# the rounds_gn probes at every cluster size and the sizes' sweep
ROUNDS_SWEEP = {}
# the steps of phases 7-9 with rounds_gn at the rule's cluster size and at
# cluster 1, in turns ({phase: {route: record}})
ROUNDS_TURNS = {}


def solve_in_turns(phase, calls, steps, step_ms):
    """Every grid_register_step call of a phase (the `tables + solve`
    stage's (args, kw, out)) again with the rounds kernel at the rule's
    cluster size and at cluster 1: a warm-up pass, then in turns (chosen,
    1, 1, chosen, twice; host wall, the device synchronized around each
    call), then the last call
    profiled on each route (device-busy share).  Prints the `time <phase>
    tables + solve in turns` line: ms a step (the calls' sum over `steps`)
    on each route and the step (step_ms, measured at the rule's) with
    cluster 1 in its place.  Returns the record (ROUNDS_TURNS[phase])."""
    import torch

    from feature_base_pointcloud_registration_tpu_torch.ops.register import (
        grid_register_step)
    ms = {"chosen": [], "C=1": []}
    diff = 0.0
    for route in ("warm-up", *("chosen", "C=1", "C=1", "chosen") * 2):
        with rounds_cluster(None if route != "C=1" else 1):
            tot = 0.0
            for a, kw, out in calls:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = grid_register_step(*a, **kw)
                torch.cuda.synchronize()
                tot += (time.perf_counter() - t0) * 1e3
                diff = max(diff, float((res.pose6 - out.pose6).abs().max()))
            ms.setdefault(route, []).append(tot / steps)
    rec = {}
    a, kw, _ = calls[-1]
    for route in ("chosen", "C=1"):
        with rounds_cluster(None if route == "chosen" else 1):
            w_p, b_p, _ = profile_call(lambda: grid_register_step(*a, **kw))
        rec[route] = dict(stage_ms_step=float(np.mean(ms[route])),
                          passes=ms[route], profiled_wall_ms=w_p,
                          profiled_busy_ms=b_p, busy_share=b_p / w_p)
    rec["step_ms"] = step_ms
    rec["step_ms_cluster1"] = (step_ms - rec["chosen"]["stage_ms_step"]
                               + rec["C=1"]["stage_ms_step"])
    rec["max_abs_err"] = diff
    ROUNDS_TURNS[phase] = rec
    print(f"time {phase} tables + solve in turns (every grid_register_step "
          f"call of the run again, the rounds kernel at the rule's cluster "
          f"size and at cluster 1, after a warm-up pass of "
          f"{ms['warm-up'][0]:.3f} ms a step, in turns): {len(calls)} calls; "
          f"a step "
          f"{rec['chosen']['stage_ms_step']:.3f} ms at the rule's "
          f"({ms['chosen']}), {rec['C=1']['stage_ms_step']:.3f} ms at "
          f"cluster 1 ({ms['C=1']}); the step {step_ms:.2f} ms at the "
          f"rule's, {rec['step_ms_cluster1']:.2f} ms with cluster 1's in its "
          f"place; the last call profiled: wall "
          f"{rec['chosen']['profiled_wall_ms']:.2f} / "
          f"{rec['C=1']['profiled_wall_ms']:.2f} ms, device busy "
          f"{rec['chosen']['busy_share']:.1%} / {rec['C=1']['busy_share']:.1%}"
          f" (the rule's / cluster 1); poses vs the run |diff| max "
          f"{diff:.3e}", flush=True)
    return rec


def record_rounds(name, n=1):
    """From now on the first n calls of the rounds solver's round (the name
    register_rounds_core calls) keep a copy of their inputs in
    ROUNDS_INPUTS[name].  Returns the function that undoes it."""
    from feature_base_pointcloud_registration_tpu_torch.ops import (
        register as treg)
    real = treg.rounds_gn
    kept = ROUNDS_INPUTS.setdefault(name, [])

    def recorded(*a, **kw):
        if len(kept) < n:
            kept.append(([t.clone() for t in a], dict(kw)))
        return real(*a, **kw)

    treg.rounds_gn = recorded
    return lambda: setattr(treg, "rounds_gn", real)


def rounds_agreement(sa, sb):
    """(lanes whose flags, iterations and n_corr agree [B] bool, pose
    |diff| [B]) of two rounds_gn results."""
    same = ((sa[:, 6] == sb[:, 6]) & (sa[:, 10] == sb[:, 10])
            & (sa[:, 7] == sb[:, 7]) & (sa[:, 8] == sb[:, 8]))
    return same, (sa[:, :6] - sb[:, :6]).abs().max(1).values


def rounds_probe(name, args, kw, fma_lib=None):
    """One `probe rounds_gn` line: the kernel against its plain version
    (rounds_gn_reference, run on the card) on the same packed inputs, both
    timed by CUDA events, with the bound, and the plain version on the CPU
    beside them (the plain version's own spread across devices).

    Lanes whose flags, iterations and n_corr agree are held to ROUNDS_TOL
    in pose and matP, degenerate ones to ROUNDS_DEG_TOL in pose; the
    others ("flips": a lane across a gate) must be fewer than 1 -
    GN_EQUAL_LANES of a batch of 20 lanes or more, and are printed with
    their size at any B.  Where the plain version itself does not hold
    those bounds against its CPU run on the same inputs (its gates flip on
    rounding noise), the kernel is held to that spread instead: pose on
    agreeing lanes within twice the plain version's, and agreeing lanes
    no fewer than its share less 0.02.  fma_lib: a build with FMA
    contraction, printed beside.  Returns the probe's record; raises where
    it fails."""
    import torch

    from feature_base_pointcloud_registration_tpu_torch import kernels
    from feature_base_pointcloud_registration_tpu_torch.ops.rounds_gn import (
        rounds_gn, rounds_gn_reference)
    K = kw["K"]
    ref_kw = {k: v for k, v in kw.items() if k != "cluster"}
    sk, mk = rounds_gn(*args, **kw)
    torch.cuda.synchronize()
    sr, mr = rounds_gn_reference(*args, **ref_kw)
    sc = rounds_gn_reference(*(t.cpu() for t in args), **ref_kw)[0].to(sr)
    B = sk.shape[0]
    same, dpose = rounds_agreement(sk, sr)
    deg = sr[:, 8] > 0
    dmat = (mk - mr).abs().max(1).values
    plain = same & ~deg

    def worst(d, m):
        return float(d[m].max()) if bool(m.any()) else 0.0

    err, err_m = worst(dpose, plain), worst(dmat, plain)
    err_deg = worst(dpose, same & deg)
    same_c, dpose_c = rounds_agreement(sr, sc)
    err_c = worst(dpose_c, same_c & ~deg)
    eq, eq_c = float(same.float().mean()), float(same_c.float().mean())
    floor = err_c > ROUNDS_TOL or (B >= 20 and eq_c < GN_EQUAL_LANES)
    tol = max(ROUNDS_TOL, 2.0 * err_c) if floor else ROUNDS_TOL
    eq_min = min(GN_EQUAL_LANES, eq_c - 0.02) if floor else GN_EQUAL_LANES
    flips = torch.nonzero(~same)[:, 0].tolist()
    again = rounds_gn(*args, **kw)
    bitwise = torch.equal(again[0], sk) and torch.equal(again[1], mk)
    ms = cuda_ms(lambda: rounds_gn(*args, **kw), 20, graph=True)
    plain_ms = cuda_ms(lambda: rounds_gn_reference(*args, **ref_kw), 2)
    C = rounds_cluster_of(args, kw)
    b_ms, b_by, _ = gn_bound(args, sr, K)
    its = (sr[:, 6] - args[0][:, 6]).long()
    rec = dict(B=B, K=K, Pc=args[2].shape[2], Ps=args[3].shape[2],
               iters=kw["iters"], spread=kw.get("min_plane_spread", 0.0),
               lane_iterations=int(its.sum()),
               max_iterations=int(its.max()), degenerate=int(deg.sum()),
               equal_lanes=eq, flips=len(flips), max_abs_err=err,
               matP_err=err_m, degenerate_err=err_deg,
               plain_card_vs_cpu_err=err_c, plain_card_vs_cpu_equal=eq_c,
               ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
               cluster=C, bitwise=bitwise)
    print(f"probe rounds_gn {name}: B={B} K={K} Pc={rec['Pc']} "
          f"Ps={rec['Ps']} spread {rec['spread']} cluster {C}"
          f"{'' if 'cluster' in kw else ' (the rule)'}: kernel {ms:.4f} ms, "
          f"plain {plain_ms:.3f} ms, bound {b_ms:.5f} ms ({b_by}, "
          f"{b_ms / ms:.2%} of it); lane-iterations "
          f"{rec['lane_iterations']} (max {rec['max_iterations']}); pose "
          f"|diff| max {err:.3e} on {int(plain.sum())} agreeing lanes, "
          f"matP {err_m:.3e}; degenerate lanes {rec['degenerate']}, pose "
          f"|diff| {err_deg:.3e}; iterations, n_corr and flags equal on "
          f"{eq:.4f} of lanes; the plain version on the card against it "
          f"on the CPU: equal on {eq_c:.4f}, pose |diff| max {err_c:.3e} "
          f"on agreeing lanes, {float(dpose_c.max()):.3e} on all; held to "
          f"{tol:.3e} and {eq_min:.4f}; two launches bitwise {bitwise}",
          flush=True)
    if fma_lib is not None:
        sf = [t.clone() for t in args[:2]]
        kernels.launch_rounds_gn(*sf, *args[2:], lib=fma_lib, **kw)
        same_f, dpose_f = rounds_agreement(sf[0], sr)
        print(f"probe rounds_gn {name}, the build with FMA contraction: "
              f"equal on {float(same_f.float().mean()):.4f}, pose |diff| "
              f"max {worst(dpose_f, same_f & ~deg):.3e} on agreeing lanes, "
              f"{float(dpose_f.max()):.3e} on all", flush=True)
    for b in flips:
        print(f"probe rounds_gn {name}: FLIP lane {b}: iterations "
              f"{int(sk[b, 6])} vs {int(sr[b, 6])}, n_corr {int(sk[b, 10])} "
              f"vs {int(sr[b, 10])}, converged {int(sk[b, 7])} vs "
              f"{int(sr[b, 7])}, degenerate {int(sk[b, 8])} vs "
              f"{int(sr[b, 8])}, pose |diff| {float(dpose[b]):.3e}",
              flush=True)
    if not (err <= tol and err_m <= ROUNDS_TOL
            and err_deg <= ROUNDS_DEG_TOL):
        raise AssertionError(f"rounds_gn {name}: pose {err} (held to "
                             f"{tol}), matP {err_m}, degenerate pose "
                             f"{err_deg}")
    if B >= 20 and not eq >= eq_min:
        raise AssertionError(f"rounds_gn {name}: lanes agree on {eq} "
                             f"(held to {eq_min})")
    if not bitwise:
        raise AssertionError(f"rounds_gn {name}: two launches differ")
    return rec


def rounds_cluster_of(args, kw):
    """The cluster size rounds_gn launches at on these inputs: kw's, or
    kernels.rounds_gn_cluster's on this card."""
    from feature_base_pointcloud_registration_tpu_torch import kernels
    if kw.get("cluster") is not None:
        return kw["cluster"]
    stat, _, fc, fs = args[:4]
    return kernels.rounds_gn_cluster_on(stat.device.index or 0, stat.shape[0],
                                        fc.shape[2] + fs.shape[2], kw["K"])


@contextlib.contextmanager
def rounds_cluster(C):
    """While the block runs, every rounds_gn launch that names no cluster
    size runs at C (None: the rule's, kernels.rounds_gn_cluster)."""
    from feature_base_pointcloud_registration_tpu_torch import kernels
    real = kernels.launch_rounds_gn

    def forced(*a, cluster=None, **kw):
        return real(*a, cluster=C if cluster is None else cluster, **kw)

    kernels.launch_rounds_gn = forced
    try:
        yield
    finally:
        kernels.launch_rounds_gn = real


def rounds_in_turns(name, args, kw, reps=20):
    """rounds_gn at the rule's C and at C = 1 on the same inputs, in turns
    (chosen, 1, 1, chosen), each timed by cuda_ms over a CUDA graph of reps
    launches; prints the `probe rounds_gn <name> in turns` line and
    returns {"chosen": ms, "C=1": ms, "cluster": C}."""
    from feature_base_pointcloud_registration_tpu_torch.ops.rounds_gn import (
        rounds_gn)
    t = {"chosen": [], "C=1": []}
    for route in ("chosen", "C=1", "C=1", "chosen"):
        c = None if route == "chosen" else 1
        t[route].append(cuda_ms(lambda: rounds_gn(*args, **kw, cluster=c),
                                reps, graph=True))
    out = {r: float(np.mean(v)) for r, v in t.items()}
    out["cluster"] = rounds_cluster_of(args, kw)
    print(f"probe rounds_gn {name} in turns (chosen, 1, 1, chosen): the "
          f"rule's cluster {out['cluster']} {out['chosen']:.4f} ms "
          f"({t['chosen']}), cluster 1 {out['C=1']:.4f} ms ({t['C=1']}): "
          f"{out['C=1'] / out['chosen']:.2f}x", flush=True)
    return out


def rounds_sweep(dev, prof):
    """`probe rounds_gn C sweep` lines: one lane at K=16 (tests/
    rounds_scenes.py's plain lane at the step's caps, Pc 2048 + Ps 8192,
    every point live) cut to its first P = Pc + Ps points, P from 320 to
    10240, at every cluster size, 6 iterations each (the convergence test
    off): us an iteration by CUDA events and the clock64 split of the
    largest P.  The least points a CTA keeps where the next larger
    cluster still gains 5% is where kernels.ROUNDS_MIN_SHARE comes from.
    Returns {P: {C: us an iteration}}."""
    import rounds_scenes as rs

    from feature_base_pointcloud_registration_tpu_torch import kernels
    from feature_base_pointcloud_registration_tpu_torch.ops.rounds_gn import (
        rounds_gn)
    K, iters = 16, 6
    full = rs.packed(rs.plain_lanes(1, K, 2048, 8192), K, dev)
    kw = dict(K=K, iters=iters, conv_rot_deg=0.0, conv_trans_cm=0.0)
    out, gains = {}, []
    for pc, ps in ((64, 256), (128, 512), (256, 1024), (512, 2048),
                   (1024, 4096), (2048, 8192)):
        stat, matP, fc, fs, cc, cs, dc, ds = full
        args = (stat, matP, fc[:, :, :pc].contiguous(),
                fs[:, :, :ps].contiguous(), cc[:, :pc].contiguous(),
                cs[:, :ps].contiguous(), dc[:, :pc].contiguous(),
                ds[:, :ps].contiguous())
        P = pc + ps
        row = {}
        for C in (1, 2, 4, 8, 16):
            row[C] = cuda_ms(lambda: rounds_gn(*args, **kw, cluster=C), 20,
                             graph=True) * 1e3 / iters
        out[P] = row
        for C in (2, 4, 8, 16):
            if row[C] <= 0.95 * row[C // 2]:
                gains.append(P // C)
        best = min(row, key=row.get)
        print(f"probe rounds_gn C sweep P={P} (Pc {pc} + Ps {ps}, all "
              f"live, K {K}): us an iteration by cluster size " + ", ".join(
                  f"{C}: {us:.2f}" for C, us in row.items())
              + f"; fastest {best} ({P // best} points a CTA)", flush=True)
        if P == 10240:
            for C in (1, 16):
                rounds_split(f"C sweep P={P} cluster {C}", args,
                             dict(kw, cluster=C), prof)
    print(f"probe rounds_gn C sweep: the least points a CTA at which "
          f"doubling the cluster still gained 5%: "
          f"{min(gains) if gains else None}; kernels.ROUNDS_MIN_SHARE "
          f"{kernels.ROUNDS_MIN_SHARE}", flush=True)
    return out


def rounds_split(name, args, kw, lib, reps=5):
    """One `probe rounds_gn ... split` line: reps launches of the
    diagnostic build (rounds_profile_build) on the same inputs, and the
    iteration's parts from its clock64 sums, in us an iteration of a CTA
    (the cycles over the clock that the kernel's own clock64 and
    globaltimer give): the point loop (to the slowest thread), the in-CTA
    reduction (reduce-scatter, the warps' sums in order), the cluster
    combine (the barrier, which waits for the slowest CTA, and the rank
    sums; 0 on one CTA) and the tail (step_warp, next_frame).  Returns the
    record."""
    import ctypes

    import torch

    from feature_base_pointcloud_registration_tpu_torch import kernels
    from feature_base_pointcloud_registration_tpu_torch.ops.rounds_gn import (
        rounds_gn)
    out = (ctypes.c_uint64 * 8)()
    torch.cuda.synchronize()
    kernels._check_rc("fbpr_rounds_gn_profile", lib.fbpr_rounds_gn_profile(
        ctypes.addressof(out), 1))
    with launching_with("launch_rounds_gn", lib):
        for _ in range(reps):
            rounds_gn(*args, **kw)
    torch.cuda.synchronize()
    kernels._check_rc("fbpr_rounds_gn_profile", lib.fbpr_rounds_gn_profile(
        ctypes.addressof(out), 1))
    its, loop, red, comb, tail, cycles, ns, ctas = (int(v) for v in out)
    ghz = cycles / max(ns, 1)
    parts = {k: v / max(its, 1) / ghz / 1e3 for k, v in (
        ("loop_us", loop), ("reduce_us", red), ("combine_us", comb),
        ("tail_us", tail))}
    total = sum(parts.values())
    rec = dict(parts, iteration_us=total, kernel_us=ns / max(ctas, 1) / 1e3,
               ghz=ghz, ctas=ctas // reps, iterations=its / max(ctas, 1),
               cluster=rounds_cluster_of(args, kw))
    print(f"probe rounds_gn {name} split (diagnostic build, clock64 on "
          f"thread 0 of each CTA, {rec['ctas']} CTAs, cluster "
          f"{rec['cluster']}, {rec['iterations']:.1f} iterations a CTA, "
          f"clock {ghz:.3f} GHz): an iteration {total:.2f} us = point loop "
          f"{parts['loop_us']:.2f} ({parts['loop_us'] / total:.1%}), in-CTA "
          f"reduction {parts['reduce_us']:.2f} "
          f"({parts['reduce_us'] / total:.1%}), cluster combine "
          f"{parts['combine_us']:.2f} ({parts['combine_us'] / total:.1%}), "
          f"tail {parts['tail_us']:.2f} ({parts['tail_us'] / total:.1%}); "
          f"the kernel {rec['kernel_us']:.2f} us a CTA", flush=True)
    return rec


def rounds_probes(dev):
    """The probe lines of rounds_gn: (a) phase 7 step 0's round 0, (b)
    phase 6's rounds 0 and 1 (B=256), (c) phase 7 (h) step 0's round 0,
    (d) tests/rounds_scenes.py's edge lanes at K 8 and 16 (a gated-off
    lane, a lane under min_corr, the degenerate tiny problem, sentinel
    picks near the world origin; min_plane_spread 0.05 at K 16).  Returns
    {name: record}."""
    import rounds_scenes as rs

    from feature_base_pointcloud_registration_tpu_torch import kernels
    fma = fma_build("rounds_gn")
    prof = rounds_profile_build()
    for K in kernels.SUPPORTED_K:
        print(f"probe rounds_gn resident clusters at K={K} (cudaOccupancy"
              f"MaxActiveClusters, 40 KB list): " + ", ".join(
                  f"{C}: {kernels.rounds_gn_max_clusters(0, K, C)}"
                  for C in (1, 2, 4, 8, 16)), flush=True)
    out, sweep = {}, {}
    for name, key, r in (("(a) phase 7 step 0 round 0", "phase 7", 0),
                         ("(b) phase 6 round 0", "phase 6", 0),
                         ("(b) phase 6 round 1", "phase 6", 1),
                         ("(c) phase 7 (h) step 0 round 0", "phase 7 (h)",
                          0)):
        args, kw = ROUNDS_INPUTS[key][r]
        out[name] = rounds_probe(name, args, kw,
                                 fma if key == "phase 6" else None)
        if name != "(b) phase 6 round 0":
            out[name]["split"] = rounds_split(name, args, kw, prof)
        if key == "phase 6":
            continue
        out[name]["in_turns"] = rounds_in_turns(name, args, kw)
        for C in (1, 2, 4, 8, 16):
            sub = f"{name} cluster {C}"
            sweep[sub] = rounds_probe(sub, args, dict(kw, cluster=C))
            sweep[sub]["split"] = rounds_split(sub, args, dict(kw, cluster=C),
                                               prof)
    for K, spread in ((8, 0.0), (16, 0.05)):
        name = f"(d) edge lanes K={K}"
        args = rs.packed(rs.edge_lanes(K), K, dev)
        kw = dict(K=K, iters=10, min_plane_spread=spread)
        out[name] = rounds_probe(name, args, kw)
        for C in (1, 2, 4, 8, 16):
            sub = f"{name} cluster {C}"
            sweep[sub] = rounds_probe(sub, args, dict(kw, cluster=C))
    ROUNDS_SWEEP.update(probes=sweep, sizes=rounds_sweep(dev, prof))
    return out


# csrc/pose_graph_lm.cu's kWarpBlocks: a block column that updates more
# later blocks than this is factored on the CTA, the others on warp 0
LM_WARP_BLOCKS = 4


def envelope_later(g):
    """(envelope starts, later blocks) of route A's envelope on g's live
    poses: graph/pose_graph.py::envelope_starts (what the kernel's
    prologue computes) and, for each block column q, the number of blocks
    p > q whose envelope starts at or before q (the blocks it updates)."""
    from feature_base_pointcloud_registration_tpu_torch.graph import (
        pose_graph as tpg)
    ls = tpg.live_set(g)
    fb = np.asarray(tpg.envelope_starts(g, ls).tolist(), np.int64)
    return fb, np.array([int((fb[q + 1:] <= q).sum()) for q in range(ls.n)],
                        np.int64)


def envelope_paths(g):
    """(block columns on warp 0, block columns on the CTA) of route A's
    envelope Cholesky on g: a column takes the CTA's path past
    LM_WARP_BLOCKS later blocks."""
    later = envelope_later(g)[1]
    wide = int((later > LM_WARP_BLOCKS).sum())
    return len(later) - wide, wide


def lm_bound(g, iterations):
    """(bound_ms, bound_by) of an LM solve of g on its live poses: the
    inputs read once and the outputs written once over the memory rate, or
    the operations a step over the fp32 rate, the larger.  A step's
    operations are what H's envelope needs (graph/pose_graph.py::
    envelope_starts, which route A's kernel computes on the card): the
    Cholesky a multiply and a subtract for each entry (u, w), w <= u, of
    each column's m rows below the diagonal, the two solves a multiply and
    a subtract for each envelope entry below the diagonal, the Jacobian
    blocks and their products: 12 x 12 x 6 a between factor, 6 x 6 x 6 a
    prior and 6 x 6 x 3 a GPS factor."""
    fb, later = envelope_later(g)
    n = len(fb)
    m = (5 - np.arange(6 * n) % 6) + 6 * later[np.arange(6 * n) // 6]
    below = int((36 * (np.arange(n) - fb) + 15).sum())
    fp, fb_, fg = (int(mk.sum()) for mk in (g.prior_mask, g.btw_mask,
                                            g.gps_mask))
    ops = iterations * (int((m * (m + 1)).sum()) + 4 * below
                        + fb_ * 12 * 12 * 6 + fp * 6 * 6 * 6
                        + fg * 6 * 6 * 3)
    K = g.poses.shape[0]
    nbytes = (K * 25 + g.prior_mask.shape[0] * 53 + g.btw_mask.shape[0] * 57
              + g.gps_mask.shape[0] * 29 + K * 24 + 4 + iterations * 4)
    return bound(nbytes, ops)


def lm_probe(name, g, iterations, unchanged=False, split=False):
    """One `probe pose_graph_lm` line: optimize_pose_graph on the card (the
    kernel, its route by the live count) against its plain version
    (optimize_pose_graph_reference, run on the card) on the same graph:
    poses within 1e-4, cost within 1e-4 relative (1e-6 absolute: a
    converged graph's cost is rounding noise), two launches bitwise equal;
    unchanged: the poses must come back bitwise.  Kernel ms by CUDA events
    (route A: the launch alone; route B: its iterations), the solve's host
    wall through the entry point, the plain version's ms.  Returns the
    probe's record; raises where it fails."""
    import torch

    from feature_base_pointcloud_registration_tpu_torch.graph import (
        pose_graph as tpg)
    opg = tpg.optimize_pose_graph
    a0, b0 = opg.launches, opg.launches_b
    acc_k, acc_p = [], []
    pk, ck = opg(g, iterations, acc_k)
    launches = {"A": opg.launches - a0, "B": opg.launches_b - b0}
    route = "A" if launches["A"] else "B"
    pk2, ck2 = opg(g, iterations)
    bitwise = bool(torch.equal(pk, pk2) and torch.equal(ck, ck2))
    pp, cp = tpg.optimize_pose_graph_reference(g, iterations, acc_p)
    err = float((pk - pp).abs().max())
    cost_err = abs(float(ck) - float(cp))
    cost_rel = cost_err / max(abs(float(cp)), 1e-30)
    agree = sum(bool(x) == bool(y) for x, y in zip(acc_k, acc_p))
    gc = tpg._contiguous(g)
    ls = tpg.live_set(gc)
    if route == "A":
        launch = lm_launcher("pose_graph_lm", gc, iterations)
        ms = cuda_ms(lambda: launch(None), 20)
    else:
        acc = torch.zeros(iterations, dtype=torch.int32,
                          device=gc.poses.device)
        ms = cuda_ms(lambda: tpg._route_b(gc, ls, iterations, acc), 3)
    walls = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        opg(g, iterations)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    plain_ms = cuda_ms(lambda: tpg.optimize_pose_graph_reference(
        g, iterations), 2)
    b_ms, b_by = lm_bound(g, iterations)
    paths = envelope_paths(gc) if route == "A" else None
    rec = dict(K=g.poses.shape[0], live=ls.n, iterations=iterations,
               route=route, launches=launches, ms=ms, paths=paths,
               solve_ms=float(np.median(walls)), plain_ms=plain_ms,
               bound_ms=b_ms, bound_by=b_by, max_abs_err=err,
               cost_rel_err=cost_rel, accepts_equal=agree,
               accepts=int(sum(bool(x) for x in acc_k)), bitwise=bitwise)
    print(f"probe pose_graph_lm {name}: K {rec['K']}, {ls.n} live, "
          f"{iterations} iterations, route {route} (launches {launches}"
          + (f"; block columns {paths[0]} on warp 0, {paths[1]} on the CTA"
             if paths else "") + f"): "
          f"kernel {ms:.4f} ms, solve {rec['solve_ms']:.3f} ms (host wall, "
          f"the entry point), plain {plain_ms:.2f} ms, bound {b_ms:.6f} ms "
          f"({b_by}, {b_ms / ms:.3%} of it); pose |diff| max {err:.3e}, "
          f"cost {float(ck):.6e} vs {float(cp):.6e} (rel {cost_rel:.3e}); "
          f"accepts {rec['accepts']}, equal on {agree}/{iterations} "
          f"iterations; two launches bitwise {bitwise}", flush=True)
    if not (err <= 1e-4 and (cost_rel <= 1e-4 or cost_err <= 1e-6)
            and bitwise):
        raise AssertionError(f"pose_graph_lm {name}: pose {err}, cost rel "
                             f"{cost_rel}, bitwise {bitwise}")
    if unchanged and not (torch.equal(pk, g.poses) and rec["accepts"] == 0):
        raise AssertionError(f"pose_graph_lm {name}: the poses moved")
    if route == "A":
        rec.update(lm_extras("pose_graph_lm", name, launch, split))
    return rec


def blocks_probe(name, g):
    """One `probe pose_graph_blocks` line: graph_factor_blocks' kernel
    against its plain version on the card: NaN in the same places, every
    other entry within 1e-5.  Returns the largest difference."""
    import torch

    from feature_base_pointcloud_registration_tpu_torch.graph import (
        pose_graph as tpg)
    got = [t for grp in tpg.graph_factor_blocks(g, g.poses) for t in grp]
    want = [t for grp in tpg.graph_factor_blocks_reference(g, g.poses)
            for t in grp]
    same_nan = all(torch.equal(torch.isnan(a), torch.isnan(b))
                   for a, b in zip(got, want))
    err = max(float(torch.where(torch.isnan(b), 0.0, a - b).abs().max())
              for a, b in zip(got, want))
    n_nan = sum(int(torch.isnan(b).sum()) for b in want)
    ms = cuda_ms(lambda: tpg.graph_factor_blocks(g, g.poses), 20)
    plain_ms = cuda_ms(lambda: tpg.graph_factor_blocks_reference(
        g, g.poses), 5)
    print(f"probe pose_graph_blocks {name}: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.3f} ms; NaN entries {n_nan}, placement equal "
          f"{same_nan}; |diff| max {err:.3e} elsewhere", flush=True)
    if not (same_nan and err <= 1e-5):
        raise AssertionError(f"pose_graph_blocks {name}: NaN placement "
                             f"{same_nan}, {err}")
    return err


def pose_graph_probes(dev):
    """The probe lines of the pose-graph LM: (a) phase 8's window graph
    (32 live poses, 8 iterations), (b) a phase 8 full graph at a loop
    closure (512 slots, 12 iterations), (c) a route-B graph (200 live poses
    of a chain with loops, in 512 slots), (d) the edge graphs of
    tests/pose_graph_scenes.py: the factor blocks at random rotations, at
    identity, near pi and near pi about an axis (NaN entries); gimbal lock
    and a rotation error near pi about an axis in the LM (H not finite:
    every step rejected, the poses bitwise); a window chain with GPS
    factors; 38 live poses with a between from pose 0 to each (the
    envelope's widest: block columns on the CTA), split; route B with its
    factorization reported failed (every step rejected).  Returns {name:
    record}."""
    import torch

    import pose_graph_scenes as pgs
    from feature_base_pointcloud_registration_tpu_torch import kernels
    out = {}
    for name in ("(a) phase 8 window", "(b) phase 8 full graph"):
        g, its = LM_INPUTS[name]
        out[name] = lm_probe(name, g, its, split=True)
    name = "(c) route B, 200 live of 512"
    out[name] = lm_probe(name, pgs.big_chain(200, device=dev)[0], 12)
    name = f"(c) route B, {kernels.POSE_GRAPH_LM_MAX_LIVE + 1} live"
    out[name] = lm_probe(name, pgs.big_chain(
        kernels.POSE_GRAPH_LM_MAX_LIVE + 1, device=dev)[0], 12)
    blk = {case: blocks_probe(f"(d) {case}", pgs.blocks_graph(case, dev))
           for case in pgs.BLOCK_CASES}
    out["(d) gimbal lock"] = lm_probe("(d) gimbal lock", pgs.gimbal(
        device=dev), 8, unchanged=True)
    out["(d) near pi about an axis"] = lm_probe(
        "(d) near pi about an axis", pgs.blocks_graph("near_pi_axis", dev),
        8, unchanged=True)
    name = "(d) gps 20"
    out[name] = lm_probe(name, pgs.chain("window", gps=True, noise=0.0,
                                         device=dev)[0], 12)
    name = f"(d) {kernels.POSE_GRAPH_LM_MAX_LIVE} live, a star"
    out[name] = lm_probe(name, pgs.star(kernels.POSE_GRAPH_LM_MAX_LIVE,
                                        device=dev)[0], 12, split=True)
    real = torch.linalg.cholesky_ex

    def failed(A):
        return (torch.eye(A.shape[0], device=A.device),
                torch.ones((), dtype=torch.int32, device=A.device))

    torch.linalg.cholesky_ex = failed
    try:
        name = "(d) route B, the factorization reported failed"
        out[name] = lm_probe(name, pgs.big_chain(
            kernels.POSE_GRAPH_LM_MAX_LIVE + 1, device=dev)[0], 2,
            unchanged=True)
    finally:
        torch.linalg.cholesky_ex = real
    out["blocks_max_abs_err"] = max(blk.values())
    return out


def imu_counters():
    """{name: wrapper} of the IMU odometry's kernel launches (each wrapper
    keeps `launches`): the chain LM (fbpr_imu_chain_lm, one a solve), its
    factor blocks (fbpr_imu_chain_blocks, one a window reset's marginal),
    the preintegration and the propagation (csrc/preintegration.cu)."""
    from feature_base_pointcloud_registration_tpu_torch.graph import (
        imu_graph as tig)
    from feature_base_pointcloud_registration_tpu_torch.imu import (
        preintegration as tpre)
    return {"imu_chain_lm": tig.optimize_imu_chain,
            "imu_chain_blocks": tig.chain_factor_blocks,
            "preintegrate": tpre.preintegrate,
            "propagate_states": tpre.propagate_states}


def chain_recorder(fn, calls, clone_ms):
    """fn (an optimize_imu_chain) appending each call's ((chain data,
    cloned: ImuOdometry updates its preintegration window in place, *args),
    kw, result) to calls; the clones' host ms summed in clone_ms["ms"],
    which the step's wall leaves out."""
    from feature_base_pointcloud_registration_tpu_torch.graph import (
        imu_graph as tig)

    def recorded(d, *a, **kw):
        t0 = time.perf_counter()
        kept = tig.ImuChainData(*(type(x)(*(t.clone() for t in x))
                                  if isinstance(x, tuple) else x.clone()
                                  for x in d))
        clone_ms["ms"] += (time.perf_counter() - t0) * 1e3
        out = fn(d, *a, **kw)
        calls.append(((kept, *a), kw, out))
        return out
    return recorded


# phase 9's IMU inputs kept for the IMU probes: chain data by probe name,
# "preintegrate" / "propagate" (args, kw) of the last calls
IMU_INPUTS = {}

# Operations the IMU kernels' functions need, counted from their
# arithmetic (csrc/imu_chain.cuh, csrc/pose_graph.cuh,
# csrc/preintegration.cu).  One operation is one float add, subtract,
# multiply, divide, compare, square root, sine, cosine or arccosine.
# Blocks, primal: a 3x3 product 9 x (3 multiplies + 2 adds); a 3x3 matrix
# times a vector 3 x 5; euler_to_rot six sines and cosines and 21 for R's
# entries; so3_exp the norm and its test 7, the axis 3, [k]x 3, [k]x^2 45,
# sin, cos, 1 - cos 3, R 9 x 4; so3_log on the branch away from pi that
# the data take (trace 2, (trace - 1) / 2 2, clamp 1, acos 1, the
# skew part 3, the test 1, 2 sin 2, theta / (2 sin) 1, the product 3).
OPS_MAT3, OPS_VEC3, OPS_EULER = 9 * 5, 3 * 5, 6 + 21
OPS_EXP = 7 + 3 + 3 + 45 + 3 + 9 * 4
OPS_LOG = 2 + 2 + 1 + 1 + 3 + 1 + 2 + 1 + 3
# Tangents (the .t halves of pose_graph.cuh's Dual operators, as
# jax.jacfwd's batched tangents of (s_i, s_j) carry them: both states vary,
# the chain data are constants): a product of two varying factors 3, with a
# constant 1; a sum 1, with a constant 0; a quotient by a varying divisor
# 3; a sine 1 and a cosine 2 (the other function is the primal's); acos 6.
OPS_EULER_T = 3 * 1 + 3 * 2 + (3 + 10 + 10 + 3 + 10 + 10 + 1 + 3 + 3)
OPS_MAT3_T, OPS_MAT3_TT = 9 * 5, 9 * (3 * 3 + 2)   # one / both varying
OPS_VEC3_T, OPS_VEC3_TT = 3 * 5, 3 * (3 * 3 + 2)
OPS_EXP_T = 7 + 3 * 3 + 3 + OPS_MAT3_TT + 4 + 9 * 7
OPS_LOG_T = 2 + 1 + 6 + 3 + 2 + 3 + 3 * 3
# The chain's factors.  Primal: the IMU residual (two rotations, g and the
# bias offsets 9, Exp(dR_dbg dbg), dR Exp, dv and dp 2 x 36, Ri^T Rj and
# dR^T (Ri^T Rj), the log, r_v 27, r_p 36), whitened by forward
# substitution 81, with the bias residual 20; the pose prior
# (local_coords and the division by sigma).  A factor's cost adds the
# squares and their sums: 18 + 12 and 12.
OPS_IMU_RES = (2 * OPS_EULER + 9 + OPS_VEC3 + OPS_EXP + OPS_MAT3
               + 2 * (2 * OPS_VEC3 + 6) + 2 * OPS_MAT3 + OPS_LOG + 27 + 36)
CHAIN_OPS_IMU = OPS_IMU_RES + 81 + 20
CHAIN_OPS_PRIOR = 2 * OPS_EULER + OPS_MAT3 + 3 + OPS_LOG + OPS_VEC3 + 6
# A Jacobian column's tangent pass: of the IMU and bias factors (30
# columns: the IMU residual's tangents, r_v and r_p 39 and 45 of them,
# whitened 81, the bias residual's 12); of the pose prior (15); of the
# init prior (15, factor 0 alone: a subtraction and a division an entry).
# The primal runs once a factor, not once a column.
CHAIN_OPS_COLUMN = (2 * OPS_EULER_T + OPS_VEC3_T + OPS_EXP_T + OPS_MAT3_T
                    + 2 * (2 * OPS_VEC3_T + 3) + 2 * OPS_MAT3_TT + OPS_LOG_T
                    + 39 + 45 + 81 + 12)
CHAIN_OPS_PRIOR_COLUMN = OPS_EULER_T + OPS_MAT3_T + 3 + OPS_LOG_T \
    + OPS_VEC3_T + 6
CHAIN_OPS_INIT_COLUMN = 15 * 2
# H's blocks a state: a diagonal block's 225 entries of (9 + 9 + 6 + 6 + 6)
# multiply-adds, a lower block's 225 of 9 + 6, grad's 15 of 36; a block of
# the Cholesky (the 120-entry update of 15 multiply-adds, the 15x15 factor
# 15^3 / 3, the off-diagonal block's 15 rows of 15^2 for L^-T) and of the
# two solves (2 x (15 x 30 + 15^2))
CHAIN_OPS_H = 225 * 72 + 225 * 30 + 15 * 72
CHAIN_OPS_CHOL_BLOCK = 120 * 30 + 1125 + 15 * 225
CHAIN_OPS_SOLVE_BLOCK = 2 * (15 * 30 + 225)
# A live sample of the preintegration: its state-free terms (a and w 6,
# w dt 3, Exp 97, Jr 98, the noise 7, int_noise 6, [a]x 3), then the
# step: dR [a]x on [a]x's 6 nonzeros 27, dR Exp 45, Exp^T dR_dbg - Jr dt
# 63, dR a 15, dR [a]x dR_dbg 45; A's entries 48; A cov and (A cov) A^T on
# A's 36 structural nonzeros (6 of them ones: 30 x 9 multiplies and 27 x 9
# adds each); (B noise) B^T on B's 27 (27 multiplies, the 45 nonzero
# entries of the product 5 each, B's entries 36); the sum and int_noise
# 84; the bias Jacobians 144; dv, dp, dt 25.  A live sample of the
# propagation: a, w dt 9, Exp 97, R Exp 45, R a + g 16, p 18, v 6.
PREINT_OPS_SAMPLE = (6 + 3 + OPS_EXP + 98 + 7 + 6 + 3
                     + 27 + OPS_MAT3 + 63 + OPS_VEC3 + OPS_MAT3 + 48
                     + 2 * (30 * 9 + 27 * 9) + (27 + 45 * 5 + 36) + 84
                     + 144 + 25)
PROPAGATE_OPS_SAMPLE = 9 + OPS_EXP + OPS_MAT3 + 16 + 18 + 6


def chain_lm_bound(d, iterations):
    """(bound_ms, bound_by) of a chain LM solve: the chain data read once
    and states, cost and accept flags written once over the memory rate,
    or the operations over the fp32 rate, the larger.  The factors are
    counted by their masks (a masked one needs nothing), the linear algebra
    over all K states (an inactive state is pinned in H)."""
    K = d.states.shape[0]
    live = d.state_mask.bool()
    n_imu = int((d.preint_mask.bool() & live).sum())
    n_pp = int((d.pose_meas_mask.bool() & live).sum())
    cost = (n_imu * (CHAIN_OPS_IMU + 30) + n_pp * (CHAIN_OPS_PRIOR + 12)
            + 2 * CHAIN_OPS_INIT_COLUMN)
    ops = (cost + K * 81 * 3 + iterations * (
        n_imu * (CHAIN_OPS_IMU + 30 * CHAIN_OPS_COLUMN)
        + n_pp * (CHAIN_OPS_PRIOR + 15 * CHAIN_OPS_PRIOR_COLUMN)
        + 15 * CHAIN_OPS_INIT_COLUMN + K * CHAIN_OPS_H + 225 * K * 4
        + K * (CHAIN_OPS_CHOL_BLOCK + CHAIN_OPS_SOLVE_BLOCK) + cost))
    nbytes = (sum(t.numel() * t.element_size() for t in d
                  if not isinstance(t, tuple))
              + sum(t.numel() * t.element_size() for t in d.preint)
              + K * 60 + 4 + iterations * 4)
    return bound(nbytes, ops)


def sample_bound(n, live, per_sample_ops, out_bytes):
    """(bound_ms, bound_by) of a preintegration or propagation of n samples
    (live of them): acc, gyr, dt and the mask read once, out_bytes
    written."""
    return bound(29 * n + out_bytes, live * per_sample_ops)


def chain_probe(name, d, iterations=4, unchanged=False, split=False):
    """One `probe imu_chain_lm` line: optimize_imu_chain on the card (the
    kernel) against its plain version (optimize_imu_chain_reference, run
    on the card) on the same chain: states within 1e-4 with NaN in the
    same places, the cost that of the kernel's states (1e-4 relative) and
    within 1e-3 relative of the plain version's (or NaN in both), one
    launch, two launches bitwise; unchanged: the states must come back
    bitwise, every step rejected.  Kernel ms by CUDA events (the launch
    alone), plain ms.  Returns the probe's record; raises where it
    fails."""
    import torch

    from feature_base_pointcloud_registration_tpu_torch.graph import (
        imu_graph as tig)
    oic = tig.optimize_imu_chain
    l0 = oic.launches
    acc_k, acc_p = [], []
    sk, ck = oic(d, iterations, acc_k)
    launches = oic.launches - l0
    sk2, ck2 = oic(d, iterations)
    both_nan = bool(torch.isnan(ck)) and bool(torch.isnan(ck2))
    bitwise = bool(torch.equal(sk, sk2) and (torch.equal(ck, ck2)
                                             or both_nan))
    sp, cp = tig.optimize_imu_chain_reference(d, iterations, acc_p)
    same_nan = bool(torch.equal(torch.isnan(sk), torch.isnan(sp)))
    fin = ~torch.isnan(sp)
    err = float((sk - sp)[fin].abs().max()) if bool(fin.any()) else 0.0
    ck_, cp_ = float(ck), float(cp)
    at = float(tig._cost(d, sk, tig._whitener(d)))
    cost_rel = abs(ck_ - cp_) / max(abs(cp_), 1e-30)
    self_rel = abs(ck_ - at) / max(abs(at), 1e-30)
    cost_ok = (np.isnan(ck_) and np.isnan(cp_)) or (
        (cost_rel <= 1e-3 or abs(ck_ - cp_) <= 1e-4)
        and (self_rel <= 1e-4 or abs(ck_ - at) <= 1e-4))
    agree = sum(bool(x) == bool(y) for x, y in zip(acc_k, acc_p))
    K = d.states.shape[0]
    launch = lm_launcher("imu_chain_lm", d, iterations)
    ms = cuda_ms(lambda: launch(None), 20)
    plain_ms = cuda_ms(lambda: tig.optimize_imu_chain_reference(
        d, iterations), 2)
    b_ms, b_by = chain_lm_bound(d, iterations)
    rec = dict(K=K, live=int(d.state_mask.sum()), iterations=iterations,
               launches=launches, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
               bound_by=b_by, max_abs_err=err, cost_rel_err=cost_rel,
               accepts_equal=agree,
               accepts=int(sum(bool(x) for x in acc_k)), bitwise=bitwise)
    print(f"probe imu_chain_lm {name}: K {K}, {rec['live']} live, "
          f"{iterations} iterations, {launches} launch: kernel {ms:.4f} ms, "
          f"plain {plain_ms:.2f} ms, bound {b_ms:.6f} ms ({b_by}, "
          f"{b_ms / ms:.3%} of it); states |diff| max {err:.3e} (NaN "
          f"placement equal {same_nan}), cost {ck_:.6e} vs {cp_:.6e} (rel "
          f"{cost_rel:.3e}; the plain cost at the kernel's states rel "
          f"{self_rel:.3e}); accepts {rec['accepts']}, equal on "
          f"{agree}/{iterations} iterations; two launches bitwise {bitwise}",
          flush=True)
    if not (err <= 1e-4 and same_nan and cost_ok and bitwise
            and launches == 1):
        raise AssertionError(f"imu_chain_lm {name}: states {err}, NaN "
                             f"{same_nan}, cost rel {cost_rel} / "
                             f"{self_rel}, bitwise {bitwise}, launches "
                             f"{launches}")
    if unchanged and not (torch.equal(sk, d.states) and rec["accepts"] == 0):
        raise AssertionError(f"imu_chain_lm {name}: the states moved")
    rec.update(lm_extras("imu_chain_lm", name, launch, split))
    return rec


CHAIN_BLOCK_NAMES = ("r_imu", "Ji", "Jj", "r_b", "Jbi", "Jbj", "r_pp", "Jpp",
                     "r_0", "J_0")


def _rel_block_err(got, want):
    """{block: |got - want| max over the finite entries / the block's
    largest finite entry of want}."""
    import torch
    out = {}
    for n, a, b in zip(CHAIN_BLOCK_NAMES, got, want):
        f = torch.isfinite(b)
        if bool(f.any()):
            scale = max(float(b[f].abs().max()), 1e-30)
            out[n] = float((a[f].double() - b[f].double()).abs().max()) / scale
    return out


def chain_blocks_probe(name, d):
    """One `probe imu_chain_blocks` line: chain_factor_blocks' kernel
    against its plain version on the card: NaN (and infinities) in the same
    places, every other entry within 1e-4 of its block's largest (the bound
    of tests/test_torch_imu.py for these blocks: whitened by sqrt(cov) ~
    1e-5, a rounding difference grows), both beside the plain version run
    in float64.  Returns the largest relative difference."""
    import torch

    from feature_base_pointcloud_registration_tpu_torch.graph import (
        imu_graph as tig)
    got = [t for g in tig.chain_factor_blocks(d, d.states) for t in g]
    want = [t for g in tig.chain_factor_blocks_reference(d, d.states)
            for t in g]
    d64 = tig.ImuChainData(*(type(x)(*(t.double() for t in x))
                             if isinstance(x, tuple)
                             else x.double() if x.is_floating_point() else x
                             for x in d))
    exact = [t for g in tig.chain_factor_blocks_reference(d64, d64.states)
             for t in g]
    same = all(torch.equal(torch.isfinite(a), torch.isfinite(b))
               and torch.equal(torch.isnan(a), torch.isnan(b))
               for a, b in zip(got, want))
    errs = _rel_block_err(got, want)
    worst = max(errs, key=errs.get)
    rel = errs[worst]
    k64, p64 = _rel_block_err(got, exact), _rel_block_err(want, exact)
    n_bad = sum(int((~torch.isfinite(b)).sum()) for b in want)
    ms = cuda_ms(lambda: tig.chain_factor_blocks(d, d.states), 20)
    plain_ms = cuda_ms(lambda: tig.chain_factor_blocks_reference(
        d, d.states), 3)
    print(f"probe imu_chain_blocks {name}: K {d.states.shape[0]}, kernel "
          f"{ms:.4f} ms, plain {plain_ms:.3f} ms; non-finite entries "
          f"{n_bad}, placement equal {same}; |diff| / block max {rel:.3e} "
          f"elsewhere ({worst}); from the float64 blocks: kernel "
          f"{max(k64.values(), default=0.0):.3e}, plain "
          f"{max(p64.values(), default=0.0):.3e}", flush=True)
    if not (same and rel <= 1e-4):
        raise AssertionError(f"imu_chain_blocks {name}: placement {same}, "
                             f"{rel}")
    return rel


# --imu-ab DIR: another version of preintegration.cu (DIR holds it and the
# headers it includes; the parent's, say), built by ab_builds ({"plain":
# lib}); every preintegrate and propagate_states probe, the GPU tests'
# buffers and phase 9's recorded calls run on it in turns with the shipped
# kernels, bit for bit (a difference fails the run)
IMU_AB = {}
# the shipped preintegration.cu's diagnostic build, built at first use
IMU_PROFILE = {}
# the warp roles of preintegration.cu's pipeline, in its -DFBPR_PREINT_PROFILE
# sums' order
PREINT_ROLES = ("cov", "dR chain", "dR_dbg chain", "state-free", "sums",
                "A terms", "y terms")


def preint_launcher(args, kw):
    """launch(lib) -> the twelve PreintState leaves: preintegrate(*args,
    **kw)'s launch alone on its prepared inputs, by the build lib of
    preintegration.cu (None: the shipped one), into the same output
    tensors each call."""
    import torch

    from feature_base_pointcloud_registration_tpu_torch import kernels
    from feature_base_pointcloud_registration_tpu_torch.imu import (
        preintegration as tpre)
    n, dev = args[0].shape[0], args[0].device
    acc, gyr, dt = tpre._samples(*args[:3])
    m = tpre._device_mask(args[3], n, dev)
    ba, bg = tpre._vec3(args[4], dev), tpre._vec3(args[5], dev)
    var = [float(v) for v in (*args[6:], *kw.values())] + [1e-8]

    def e(*shape):
        return torch.empty(shape, device=dev)

    out = tpre.PreintState(e(3, 3), e(3), e(3), e(), e(3, 3), e(3, 3),
                           e(3, 3), e(3, 3), e(3, 3), e(9, 9), e(3), e(3))

    def launch(lib):
        kernels.launch_preintegrate(acc, gyr, dt, m, ba, bg, out,
                                    acc_var=var[0], gyr_var=var[1],
                                    int_var=var[2], lib=lib)
        return out
    return launch


def propagate_launcher(args, kw):
    """launch(lib) -> (R, p, v): propagate_states(*args, **kw)'s launch
    alone on its prepared inputs, by the build lib (None: the shipped
    one), into the same output tensors each call."""
    import torch

    from feature_base_pointcloud_registration_tpu_torch import kernels
    from feature_base_pointcloud_registration_tpu_torch.imu import (
        preintegration as tpre)
    n, dev = args[3].shape[0], args[3].device
    acc, gyr, dt = tpre._samples(*args[3:6])
    m = tpre._device_mask(args[6], n, dev)
    ba, bg = tpre._vec3(args[1], dev), tpre._vec3(args[2], dev)
    nav = tpre.NavState(*(torch.as_tensor(t, dtype=torch.float32,
                                          device=dev).contiguous()
                          for t in args[0]))
    gravity = float(kw.get("gravity", args[7] if len(args) > 7 else 9.80511))
    out = tpre.NavState(torch.empty(n, 3, 3, device=dev),
                        torch.empty(n, 3, device=dev),
                        torch.empty(n, 3, device=dev))

    def launch(lib):
        kernels.launch_propagate_states(nav, ba, bg, acc, gyr, dt, m, out,
                                        gravity=gravity, lib=lib)
        return out
    return launch


def imu_profile(launch, lib, reps=5):
    """The 19 clock64 sums of reps launches of preintegration.cu's
    diagnostic build lib (-DFBPR_PREINT_PROFILE) through launch."""
    import ctypes

    import torch

    from feature_base_pointcloud_registration_tpu_torch import kernels
    out = (ctypes.c_uint64 * 19)()
    torch.cuda.synchronize()
    rd = lib.fbpr_preintegrate_profile
    kernels._check_rc("fbpr_preintegrate_profile",
                      rd(ctypes.addressof(out), 1))
    for _ in range(reps):
        launch(lib)
    torch.cuda.synchronize()
    kernels._check_rc("fbpr_preintegrate_profile",
                      rd(ctypes.addressof(out), 1))
    return [int(v) for v in out]


def propagate_split(name, launch, lib, reps=5):
    """One `probe propagate_states <name> split` line: the walking warp's
    clock64 cycles a slot in the diagnostic build.  Returns the record."""
    calls, slots, cycles = imu_profile(launch, lib, reps)[13:16]
    rec = dict(walk_cycles_slot=cycles / max(slots, 1),
               slots=slots / max(calls, 1))
    print(f"probe propagate_states {name} split (diagnostic build, clock64 "
          f"on the walking warp): {rec['slots']:.0f} slots, "
          f"{rec['walk_cycles_slot']:.1f} cycles a slot", flush=True)
    return rec


def preint_split(name, launch, lib, reps=5):
    """One `probe preintegrate <name> split` line: reps launches of the
    diagnostic build lib (-DFBPR_PREINT_PROFILE) through launch
    (preint_launcher) and its clock64 sums: the cycles each warp role's
    lane 0 spent in its stage's work, in us a call, the cov warp's cycles a
    live sample, the pipeline steps and the dense cov steps a call.
    Returns the record."""
    prof = imu_profile(launch, lib, reps)
    calls, live, steps, *busy, cycles, ns, dense = prof[:13]
    step = [v / max(live, 1) for v in prof[16:19]]
    calls = max(calls, 1)
    ghz = cycles / max(ns, 1)
    busy_us = {r: b / calls / ghz / 1e3 for r, b in zip(PREINT_ROLES, busy)}
    rec = dict(call_us=ns / calls / 1e3, ghz=ghz, busy_us=busy_us,
               steps=steps / calls, live=live / calls,
               cov_cycles_live=busy[0] / max(live, 1), dense=dense / calls,
               cov_step_cycles=dict(zip(("loads and A cov",
                                         "shuffles and T1 A^T",
                                         "vote, store, sync"), step)))
    print(f"probe preintegrate {name} split (diagnostic build, clock64 on "
          f"lane 0 of each warp, clock {ghz:.3f} GHz): a call "
          f"{rec['call_us']:.2f} us, {rec['steps']:.0f} pipeline steps, "
          f"{rec['live']:.0f} live samples; busy " + ", ".join(
              f"{r} {u:.2f}" for r, u in busy_us.items())
          + f" us; the cov warp {rec['cov_cycles_live']:.1f} cycles a live "
          f"sample (a step split at two stamps, each adding a shared store "
          f"and a __syncwarp: " + ", ".join(
              f"{k} {v:.1f}" for k, v in rec["cov_step_cycles"].items())
          + f"); dense cov steps {rec['dense']:.0f}", flush=True)
    return rec


def imu_extras(kind, name, launch, split):
    """A preintegrate or propagate_states probe's additions through launch:
    the launch's device ms in a CUDA graph (graph_ms: the host's ~0.03 ms a
    ctypes launch left out), the diagnostic split (if split) and, given
    --imu-ab, the other version in turns (in CUDA graphs), bit for bit or
    it raises."""
    rec = {"graph_ms": cuda_ms(lambda: launch(None), 20, graph=True)}
    print(f"probe {kind} {name}: the launch on the device alone (20 in a "
          f"CUDA graph) {rec['graph_ms']:.4f} ms", flush=True)
    if split:
        if not IMU_PROFILE:
            IMU_PROFILE.update(ab_builds(("preintegration",),
                                         profile="-DFBPR_PREINT_PROFILE"))
        rec["split"] = (preint_split if kind == "preintegrate"
                        else propagate_split)(name, launch,
                                              IMU_PROFILE["preintegration"])
    if IMU_AB:
        rec["in_turns"] = lm_turns(kind, name, launch, IMU_AB["plain"],
                                   flag="--imu-ab", graph=True)
        if not rec["in_turns"]["bitwise_other"]:
            raise AssertionError(f"{kind} {name}: the kernel differs from "
                                 "the other version's")
    return rec


def imu_scene_turns(dev):
    """Given --imu-ab: tests/imu_chain_scenes.py's buffers and edge buffers
    (the GPU tests') on the shipped kernels and the other version's, bit
    for bit or it raises."""
    import torch

    import imu_chain_scenes as ics
    from feature_base_pointcloud_registration_tpu_torch.imu import (
        preintegration as tpre)
    nav = tpre.NavState(
        torch.from_numpy(ics.rot((0.1, -0.2, 0.7)).astype(np.float32)).to(
            dev), torch.tensor([1.0, -2.0, 0.5], device=dev),
        torch.tensor([1.2, 0.1, 0.0], device=dev))
    n = 0
    for kind in ics.BUFFERS + ics.EDGE_BUFFERS:
        acc, gyr, dt, m, ba, bg = ics.buffer(kind, dev)
        for launch in (preint_launcher((acc, gyr, dt, m, ba, bg, ics.ACC_VAR,
                                        ics.GYR_VAR), {}),
                       propagate_launcher((nav, ba, bg, acc, gyr, dt, m),
                                          dict(gravity=ics.G))):
            mine = [t.clone() for t in launch(None)]
            theirs = launch(IMU_AB["plain"])
            if not all(_same_bits(a, b) for a, b in zip(mine, theirs)):
                raise AssertionError(f"IMU scene {kind}: the kernels differ "
                                     "from the other version's")
            n += 1
    print(f"probe preintegrate/propagate_states scenes against the other "
          f"version (--imu-ab): {n} calls on the GPU tests' {n // 2} "
          f"buffers, outputs bit for bit equal True", flush=True)
    return n


def imu_phase9_turns():
    """Phase 9's recorded preintegrate and propagate_states calls again on
    their launches alone: device ms a LIO step of both (all calls once,
    five times over in a CUDA graph: the host's ctypes launches, ~0.02 ms
    each, left out) and, given --imu-ab, the other version's in turns
    (shipped, other, other, shipped), every call bit for bit or it
    raises.  Returns the record."""
    import torch
    rec9 = IMU_INPUTS["phase9_calls"]
    launches = [preint_launcher(a, kw) for a, kw in rec9["preintegrate"]] \
        + [propagate_launcher(a, kw) for a, kw in rec9["propagate"]]
    steps = rec9["steps"]
    if IMU_AB:
        for i, launch in enumerate(launches):
            mine = [t.clone() for t in launch(None)]
            theirs = launch(IMU_AB["plain"])
            if not all(_same_bits(a, b) for a, b in zip(mine, theirs)):
                raise AssertionError(f"phase 9 IMU call {i}: the kernel "
                                     "differs from the other version's")

    def every(lib):
        for launch in launches:
            launch(lib)

    routes = ("shipped", "other", "other", "shipped") if IMU_AB \
        else ("shipped",)
    ms = {"shipped": [], "other": []}
    for route in routes:
        lib = IMU_AB["plain"] if route == "other" else None
        ms[route].append(cuda_ms(lambda: every(lib), 5, graph=True) / steps)
    torch.cuda.synchronize()
    rec = dict(calls=len(launches), steps=steps,
               kernel_ms_step=float(np.mean(ms["shipped"])))
    line = (f"time phase 9 preintegration + propagation: "
            f"{len(rec9['preintegrate'])} preintegrate and "
            f"{len(rec9['propagate'])} propagate_states calls again on their "
            f"launches alone (in a CUDA graph), {rec['kernel_ms_step']:.4f} "
            f"ms a LIO step ({steps} steps)")
    if IMU_AB:
        rec.update(ms=ms["shipped"], other_ms=ms["other"],
                   other_ms_step=float(np.mean(ms["other"])),
                   bitwise_other=True)
        line += (f"; in turns with the other version (--imu-ab): kernel "
                 f"{ms['shipped'][0]:.4f} / {ms['shipped'][1]:.4f}, other "
                 f"{ms['other'][0]:.4f} / {ms['other'][1]:.4f} ms a step: "
                 f"{rec['other_ms_step'] / rec['kernel_ms_step']:.2f}x; "
                 f"every call bit for bit equal True")
    print(line, flush=True)
    return rec


def preint_probe(name, args, kw, split=False):
    """One `probe preintegrate` line: preintegrate on the card (the kernel)
    against preintegrate_reference on the card with the same arguments,
    held by tests/imu_chain_scenes.py's preint_agreement: up to 64 live
    samples dR, dv, dp, dt and the bias Jacobians within 1e-6 of max(1,
    their largest entry) and cov within rtol 1e-5 with a floor of 1e-7 of
    its largest entry; above, 1e-5 and a floor of 1e-6, where the kernel is
    as near a float64 run of the plain version as the plain version is,
    within a factor of 2; two launches bitwise.  Kernel ms: the launch
    alone; the entry point's beside it; with split, the diagnostic build's
    split; given --imu-ab, the other version in turns.  Returns the
    probe's record."""
    import torch

    import imu_chain_scenes as ics
    from feature_base_pointcloud_registration_tpu_torch.imu import (
        preintegration as tpre)
    n = args[0].shape[0]
    l0 = tpre.preintegrate.launches
    got = tpre.preintegrate(*args, **kw)
    launches = tpre.preintegrate.launches - l0
    again = tpre.preintegrate(*args, **kw)
    bitwise = all(torch.equal(a, b) for a, b in zip(got, again))
    want = tpre.preintegrate_reference(*args, **kw)
    ok, rep = ics.preint_agreement(got, want, args, kw)
    live, errs = rep["live"], rep["errs"]
    # the launch alone on the entry point's prepared inputs, and the entry
    # point (its copies of strided samples, uploads and allocations)
    launch = preint_launcher(args, kw)
    ms = cuda_ms(lambda: launch(None), 20)
    entry_ms = cuda_ms(lambda: tpre.preintegrate(*args, **kw), 20)
    plain_ms = cuda_ms(lambda: tpre.preintegrate_reference(*args, **kw), 2)
    b_ms, b_by = sample_bound(n, live, PREINT_OPS_SAMPLE, 148 * 4)
    rec = dict(N=n, live=live, launches=launches, ms=ms, entry_ms=entry_ms,
               plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
               max_abs_err=max(errs.values()), bitwise=bitwise)
    print(f"probe preintegrate {name}: {n} samples, {live} live, {launches} "
          f"launch: kernel {ms:.4f} ms (the entry point {entry_ms:.4f} ms), "
          f"plain {plain_ms:.2f} ms, bound "
          f"{b_ms:.6f} ms ({b_by}, {b_ms / ms:.3%} of it); |diff| max "
          + ", ".join(f"{f} {e:.2e}" for f, e in errs.items())
          + f", the cov floor it needs {rep['cov_floor_needed']:.2e} of the "
          f"largest entry" + ("".join(
              f"; from the float64 plain version, {w} (leaves, cov) "
              f"{rep[k][0]:.3e}, {rep[k][1]:.3e}"
              for w, k in (("kernel", "kernel_f64"), ("plain", "plain_f64")))
              if "kernel_f64" in rep else "")
          + f" (within bounds {ok}); two launches bitwise {bitwise}",
          flush=True)
    if not (ok and bitwise and launches == 1):
        raise AssertionError(f"preintegrate {name}: {errs}, bitwise "
                             f"{bitwise}, launches {launches}")
    rec.update(imu_extras("preintegrate", name, launch, split))
    return rec


def propagate_probe(name, args, kw):
    """One `probe propagate_states` line: propagate_states on the card
    against propagate_states_reference on the card: R, p, v within 1e-5 of
    max(1, their largest entry), two launches bitwise.  Kernel ms: the
    launch alone; the entry point's beside it.  Returns the probe's
    record."""
    import torch

    from feature_base_pointcloud_registration_tpu_torch.imu import (
        preintegration as tpre)
    n = args[3].shape[0]
    mask = args[6]
    live = n if mask is None else int(torch.as_tensor(mask).sum())
    l0 = tpre.propagate_states.launches
    got = tpre.propagate_states(*args, **kw)
    launches = tpre.propagate_states.launches - l0
    again = tpre.propagate_states(*args, **kw)
    bitwise = all(torch.equal(a, b) for a, b in zip(got, again))
    want = tpre.propagate_states_reference(*args, **kw)
    errs = [float((a - b).abs().max()) for a, b in zip(got, want)]
    ok = all(e <= 1e-5 * max(1.0, float(b.abs().max()))
             for e, b in zip(errs, want))
    launch = propagate_launcher(args, kw)
    ms = cuda_ms(lambda: launch(None), 20)
    entry_ms = cuda_ms(lambda: tpre.propagate_states(*args, **kw), 20)
    plain_ms = cuda_ms(lambda: tpre.propagate_states_reference(*args, **kw),
                       2)
    b_ms, b_by = sample_bound(n, live, PROPAGATE_OPS_SAMPLE, 60 * n)
    rec = dict(N=n, live=live, launches=launches, ms=ms, entry_ms=entry_ms,
               plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
               max_abs_err=max(errs), bitwise=bitwise)
    print(f"probe propagate_states {name}: {n} samples, {live} live, "
          f"{launches} launch: kernel {ms:.4f} ms (the entry point "
          f"{entry_ms:.4f} ms), plain {plain_ms:.2f} ms, "
          f"bound {b_ms:.6f} ms ({b_by}, {b_ms / ms:.3%} of it); R, p, v "
          f"|diff| max {errs[0]:.2e}, {errs[1]:.2e}, {errs[2]:.2e} (within "
          f"1e-5 {ok}); two launches bitwise {bitwise}", flush=True)
    if not (ok and bitwise and launches == 1):
        raise AssertionError(f"propagate_states {name}: {errs}, bitwise "
                             f"{bitwise}, launches {launches}")
    rec.update(imu_extras("propagate_states", name, launch, True))
    return rec


def imu_probes(dev):
    """The probe lines of the IMU odometry's kernels: `probe imu_chain_lm`
    at (a) phase 9's last full window, (b) its first correction after a
    window reset, (c) K 100 (tests/imu_chain_scenes.py), (d) the edge
    scenes of tests/imu_chain_scenes.py;
    `probe imu_chain_blocks` on (a) and the scenes; `probe preintegrate` and
    `probe propagate_states` at phase 9's interval, a 64-sample capped
    interval and a 1024-sample buffer with interior masked samples (each
    preintegration with its diagnostic split); phase 9's recorded
    preintegrate and propagate_states calls again (imu_phase9_turns); given
    --imu-ab, the GPU tests' buffers on both versions (imu_scene_turns).
    Returns {"chain": {name: record}, "blocks_max_rel_err": x, "preint":
    {...}, "propagate": {...}, "phase9": {...}, "scenes": calls or None}."""
    import torch

    import imu_chain_scenes as ics
    from feature_base_pointcloud_registration_tpu_torch.imu import (
        preintegration as tpre)
    chain = {}
    for name in ("(a) phase 9 last full window",
                 "(b) phase 9 first correction after a reset"):
        chain[name] = chain_probe(name, IMU_INPUTS[name],
                                  split=name.startswith("(a)"))
    chain["(c) K 100"] = chain_probe("(c) K 100", ics.scene("k100", dev),
                                     split=True)
    for sc in ics.CPU_SCENES:
        chain[f"(d) {sc}"] = chain_probe(
            f"(d) {sc}", ics.scene(sc, dev),
            unchanged=sc in ("nan_cov", "near_pi_axis"))
    blk = [chain_blocks_probe("(a) phase 9 last full window",
                              IMU_INPUTS["(a) phase 9 last full window"])]
    blk += [chain_blocks_probe(f"(d) {sc}", ics.scene(sc, dev))
            for sc in ics.SCENES]
    preint, prop = {}, {}
    a, kw = IMU_INPUTS["preintegrate"]
    preint["phase 9 interval"] = preint_probe("phase 9 interval", a, kw,
                                              split=True)
    a, kw = IMU_INPUTS["propagate"]
    prop["phase 9 stream"] = propagate_probe("phase 9 stream", a, kw)
    nav = tpre.NavState(
        torch.from_numpy(ics.rot((0.1, -0.2, 0.7)).astype(np.float32)).to(
            dev), torch.tensor([1.0, -2.0, 0.5], device=dev),
        torch.tensor([1.2, 0.1, 0.0], device=dev))
    for kind, name in (("cap64", "64-sample capped interval"),
                       ("buffer1024", "1024-sample buffer, interior "
                                      "masked samples")):
        acc, gyr, dt, m, ba, bg = ics.buffer(kind, dev)
        preint[name] = preint_probe(name, (acc, gyr, dt, m, ba, bg,
                                           ics.ACC_VAR, ics.GYR_VAR), {},
                                    split=True)
        prop[name] = propagate_probe(name, (nav, ba, bg, acc, gyr, dt, m),
                                     dict(gravity=ics.G))
    return {"chain": chain, "blocks_max_rel_err": max(blk),
            "preint": preint, "propagate": prop,
            "phase9": imu_phase9_turns(),
            "scenes": imu_scene_turns(dev) if IMU_AB else None}

# the inputs of ICP runs and k-NN calls of the phases, kept for the
# `probe icp` / `probe knn` lines ({name: (args, kw)})
ICP_INPUTS = {}
KNN_INPUTS = {}
# phase 8's ICP runs again on the kernel and on the parent's loop
ICP_TURNS = {}
# --knn-icp-ab DIR: another version of knn_stream.cu and icp.cu (DIR holds
# them and the headers they include; the parent's, say), built by
# ab_builds: {"plain": {stem: lib}, "profile": {"icp": lib}}; the knn and
# ICP probes, the GPU tests' scenes and phase 8's ICP runs run it in turns
# with the shipped kernels, bit for bit, and the ICP probes print its
# clock64 split beside theirs
KI_AB = {}
# the shipped icp.cu's diagnostic build ({"icp": lib}), built at first use
KI_PROFILE = {}
# icp.cu's clock64 stages (-DFBPR_ICP_PROFILE): the prologue and the
# epilogue once a run, the rest a trip
ICP_STAGES = ("prologue", "1-NN", "C", "M", "H", "S", "grid barriers",
              "grid_sums", "epilogue")


def knn_icp_counters():
    """{name: wrapper} of the k-NN and ICP kernels (ops/knn.py::knn, one
    fbpr_knn launch a call; ops/icp.py::icp_align, one fbpr_icp launch a
    run), each with its `launches` count."""
    from feature_base_pointcloud_registration_tpu_torch.ops import (
        icp as ticp, knn as tknn)
    return {"knn": tknn.knn, "icp": ticp.icp_align}


@contextlib.contextmanager
def icp_recorder(module, key):
    """While the block runs, module.icp_align keeps its first call's inputs
    in ICP_INPUTS[key] (a first recorded input stays)."""
    real = module.icp_align

    def recorded(*a, **kw):
        ICP_INPUTS.setdefault(key, (a, kw))
        return real(*a, **kw)

    module.icp_align = recorded
    try:
        yield
    finally:
        module.icp_align = real


def icp_in_turns(calls):
    """Every recorded icp_align call ((args, kw, out)) again on the kernel,
    on the parent's loop (icp_align_reference on the card, the route
    before the kernel) and, given --knn-icp-ab, on the other version's
    kernel, in turns (the kernel first on even calls, last on odd ones):
    [(kernel ms, plain ms, kernel iterations, plain iterations, transform
    |diff|, other kernel ms or None, outputs bit for bit the other
    kernel's or None)], host wall with the device synchronized."""
    import torch

    from feature_base_pointcloud_registration_tpu_torch.ops import (
        icp as ticp)
    routes = ("kernel", "other", "plain") if KI_AB else ("kernel", "plain")
    out = []
    for i, (a, kw, _) in enumerate(calls):
        ms, res = {}, {}
        other = icp_launcher(a, kw) if KI_AB else None
        for route in (routes if i % 2 == 0 else routes[::-1]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if route == "other":
                res[route] = [t.clone() for t in
                              other(KI_AB["plain"]["icp"])]
            else:
                fn = (ticp.icp_align if route == "kernel"
                      else ticp.icp_align_reference)
                res[route] = fn(*a, **kw)
            torch.cuda.synchronize()
            ms[route] = (time.perf_counter() - t0) * 1e3
        out.append((ms["kernel"], ms["plain"],
                    int(res["kernel"].iterations),
                    int(res["plain"].iterations),
                    float((res["kernel"].transform
                           - res["plain"].transform).abs().max()),
                    ms.get("other"),
                    all(_same_bits(x, y) for x, y in zip(res["kernel"],
                                                         res["other"]))
                    if KI_AB else None))
    return out


def icp_launcher(args, kw):
    """launch(lib) -> the outputs (T, fitness, converged, iterations,
    delta): one icp_align run of args, kw by the build lib of icp.cu
    (None: the shipped one; its own plan and scratch), as icp_align
    launches it, into the same output tensors each call."""
    import torch

    from feature_base_pointcloud_registration_tpu_torch import kernels
    src, sm, dst, dm = (t.contiguous() for t in args[:4])
    dev = src.device
    out = (torch.empty(4, 4, device=dev), torch.empty((), device=dev),
           torch.empty((), dtype=torch.bool, device=dev),
           torch.empty((), dtype=torch.int32, device=dev),
           torch.empty((), device=dev))
    k = dict(chunk=kw.get("chunk", 2048),
             max_d2=float(kw.get("max_corr_dist", 100.0)) ** 2,
             max_iterations=int(kw.get("max_iterations", 100)),
             eps=float(kw.get("transformation_epsilon", 1e-6)))

    def launch(lib):
        kernels.launch_icp(src, sm, dst, dm, out, lib=lib, **k)
        return out
    return launch


def knn_launcher(q, ref, mask, k, chunk):
    """launch(lib) -> (d2, idx): one knn call's launch by the build lib of
    knn_stream.cu (None: the shipped one), with the call's centroid, into
    the same output tensors each call."""
    import torch

    from feature_base_pointcloud_registration_tpu_torch import kernels
    q3 = q.reshape(-1, q.shape[-2], 3).contiguous()
    center = q3.mean(-2)
    r3 = (ref.reshape(-1, *ref.shape[-2:]) if ref.dim() > 2
          else ref).contiguous()
    m2 = (mask.reshape(-1, mask.shape[-1]) if mask.dim() > 1
          else mask).contiguous()
    d2 = torch.empty(*q3.shape[:2], k, device=q.device)
    idx = torch.empty(*q3.shape[:2], k, dtype=torch.int32, device=q.device)

    def launch(lib):
        kernels.launch_knn(q3, center, r3, m2, d2, idx,
                           one_chunk=ref.shape[-2] == chunk, lib=lib)
        return d2, idx
    return launch


def icp_split(name, launch, lib, which, reps=5):
    """One `probe icp <name> split` line: reps runs by the diagnostic
    build lib (-DFBPR_ICP_PROFILE) through launch (icp_launcher), and the
    stages of a trip from their clock64 sums on thread 0 of every CTA
    after a CTA barrier (clock_prof.cuh), a CTA's mean, in us (the cycles
    over the clock that clock64 and globaltimer give): the 1-NN, C, M, H,
    S, the grid barriers, grid_sums; the prologue and the epilogue in us a
    run; the keys computed a trip (this build counts them; 0 where the
    build does not).  Returns the record."""
    import ctypes

    import torch

    from feature_base_pointcloud_registration_tpu_torch import kernels
    out = (ctypes.c_uint64 * 14)()
    torch.cuda.synchronize()
    kernels._check_rc("fbpr_icp_profile",
                      lib.fbpr_icp_profile(ctypes.addressof(out), 1))
    for _ in range(reps):
        launch(lib)
    torch.cuda.synchronize()
    kernels._check_rc("fbpr_icp_profile",
                      lib.fbpr_icp_profile(ctypes.addressof(out), 1))
    ctas, trips, *stage = (int(v) for v in out)
    cycles, ns, nkeys = stage[len(ICP_STAGES):len(ICP_STAGES) + 3]
    ghz = cycles / max(ns, 1)
    trips_run = trips / reps
    # a CTA's mean over every run (ctas counts the CTAs of all reps runs)
    us = {n: stage[i] / max(ctas, 1) / ghz / 1e3
          for i, n in enumerate(ICP_STAGES)}
    per_trip = {n: us[n] / max(trips_run, 1) for n in ICP_STAGES
                if n not in ("prologue", "epilogue")}
    trip_us = sum(per_trip.values())
    rec = dict(trip_us=trip_us, stages_us=per_trip,
               prologue_us=us["prologue"], epilogue_us=us["epilogue"],
               run_us=ns / max(ctas, 1) / 1e3, ghz=ghz,
               trips=trips_run, keys_trip=nkeys / max(trips, 1),
               ctas=ctas / reps)
    print(f"probe icp {name} split ({which}, clock64 on thread 0 of each of "
          f"{rec['ctas']:.0f} CTAs after a CTA barrier, their mean; "
          f"{trips_run:.0f} trips a run, clock {ghz:.3f} GHz): a trip "
          f"{trip_us:.2f} us = " + ", ".join(
              f"{n} {v:.2f} ({v / max(trip_us, 1e-9):.1%})"
              for n, v in per_trip.items()) + f"; a run {rec['run_us']:.2f} "
          f"us (prologue {rec['prologue_us']:.2f}, epilogue "
          f"{rec['epilogue_us']:.2f}); keys a trip "
          f"{rec['keys_trip']:.0f}", flush=True)
    return rec


def scene_turns(dev):
    """Given --knn-icp-ab: the GPU tests' k-NN and ICP scenes
    (tests/test_torch_kernels_cuda.py's shapes: icp_scenes' k-NN scenes at
    k 1, 5, 16, a shared map and one map per set, one chunk and four; its
    ICP cases; the edge scenes through knn at k 1, 5, 16 and icp_align) on
    the shipped kernels and on the other version's, each output bit for
    bit.  Returns {"knn": cases, "icp": cases, "bitwise": bool}."""
    import torch

    import icp_scenes as iscn
    T = functools.partial(torch.as_tensor, device=dev)
    knn_other, icp_other = KI_AB["plain"]["knn_stream"], KI_AB["plain"]["icp"]
    same, n_knn, n_icp = True, 0, 0

    def both(launch, other):
        a = [t.clone() for t in launch(None)]
        b = [t.clone() for t in launch(other)]
        return all(_same_bits(x, y) for x, y in zip(a, b))

    M = 4096
    for scene in iscn.KNN_SCENES:
        for chunks in ("one", "four"):
            chunk = M if chunks == "one" else M // 4
            for maps in ("shared", "per_set"):
                sets = [iscn.knn_scene(scene, M, chunk, Q=2000, seed=sd)
                        for sd in ((0,) if maps == "shared" else (0, 1))]
                q, ref, mask = ([T(a) for a in sets[0]] if maps == "shared"
                                else [T(np.stack(a)) for a in zip(*sets)])
                for k in (1, 5, 16):
                    same &= both(knn_launcher(q, ref, mask, k, chunk),
                                 knn_other)
                    n_knn += 1
    icp_caps = {"small": (256, 1024, 256), "phase8": (4096, 16384, 2048),
                "pair": (2048, 2048, 2048), "merge": (4096, 4096, 2048)}
    cases = [(iscn.icp_scene, s_, "small") for s_ in iscn.ICP_SCENES] + [
        (iscn.icp_scene, "room", "phase8"), (iscn.icp_scene, "pair", "pair"),
        (iscn.icp_scene, "merge", "merge")] + [
        (iscn.edge_scene, s_, None) for s_ in iscn.EDGE_SCENES]
    for make, scene, caps in cases:
        shape = {} if caps is None else dict(zip(("N", "M", "chunk"),
                                                 icp_caps[caps]))
        src, sm, dst, dm, kw = make(scene, **shape)
        args = [T(a) for a in (src, sm, dst, dm)]
        same &= both(icp_launcher(args, kw), icp_other)
        n_icp += 1
        if caps is None:
            for k in (1, 5, 16):
                same &= both(knn_launcher(args[0], args[2], args[3], k,
                                          kw["chunk"]), knn_other)
                n_knn += 1
    print(f"probe knn/icp scenes against the other version (--knn-icp-ab): "
          f"{n_knn} knn calls and {n_icp} icp_align runs of the GPU tests' "
          f"scenes, outputs bit for bit equal {same}", flush=True)
    if not same:
        raise AssertionError("knn/icp scenes: the kernels differ from the "
                             "other version's")
    return {"knn": n_knn, "icp": n_icp, "bitwise": same}


def variant_build(stem, extra_flags, label):
    """A build of csrc/<stem>.cu with extra_flags on top of the shipped
    ones (kernels._flags: an -fmad= among them replaces the shipped one),
    loaded; its ptxas lines printed under label."""
    from feature_base_pointcloud_registration_tpu_torch import kernels
    so = kernels._build([kernels.CSRC / f"{stem}.cu"], extra_flags)[0]
    print_ptxas(label, kernels.BUILD_DIR / (so.stem + ".log"))
    return kernels.load(so)


def fma_build(stem):
    """A build of csrc/<stem>.cu with FMA contraction (the shipped one has
    none: kernels.SOURCE_FLAGS), loaded."""
    return variant_build(stem, ["-fmad=true"], label=f"{stem} (FMA build)")


def rounds_profile_build():
    """rounds_gn.cu's diagnostic build: the shipped flags and
    -DFBPR_ROUNDS_PROFILE (clock64 stamps, fbpr_rounds_gn_profile)."""
    return variant_build("rounds_gn", ["-DFBPR_ROUNDS_PROFILE"],
                         "rounds_gn (diagnostic build)")



@contextlib.contextmanager
def launching_with(name, lib):
    """While the block runs, kernels.<name> launches the build lib."""
    from feature_base_pointcloud_registration_tpu_torch import kernels
    real = getattr(kernels, name)
    setattr(kernels, name, functools.partial(real, lib=lib))
    try:
        yield
    finally:
        setattr(kernels, name, real)


def knn_bound(q, ref, mask, k):
    """(bound_ms, bound_by) of one k-NN call: queries [S, Q, 3] (12 B a
    point), the map (13 B a point, once a set for per-set maps), the
    centroids and outputs (8 B a slot) moved once; KNN_OPS_PAIR operations
    a (query, live map point) pair of each set."""
    S, Q = q.shape[0], q.shape[1]
    M = ref.shape[-2]
    live = int(mask.sum()) * (S if mask.dim() == 1 else 1)
    nbytes = 12 * S * Q + 13 * M * (S if ref.dim() == 3 else 1) \
        + 12 * S + 8 * k * S * Q
    return bound(nbytes, KNN_OPS_PAIR * Q * live)


def icp_bound(args, trips):
    """(bound_ms, bound_by) of one ICP run of `trips` trips (iterations + the
    final fitness pass): src and dst with their masks (13 B a point) read
    once, the outputs (80 B) written once; a trip's KNN_OPS_PAIR
    operations a (live source row, live target point) pair and
    ICP_OPS_ROW a source row."""
    src, src_mask, dst, dst_mask = args[:4]
    N, M = src.shape[0], dst.shape[0]
    pairs = int(src_mask.sum()) * int(dst_mask.sum())
    return bound(13 * (N + M) + 80,
                 trips * (KNN_OPS_PAIR * pairs + ICP_OPS_ROW * N))


def knn_probe(name, q, ref, mask, k, chunk, fma_lib):
    """One `probe knn` line: the kernel (knn on the card, one launch)
    against its plain version (knn_reference on the card) on one call's
    inputs, held by icp_scenes.knn_agreement (no-neighbour slots exact, d2
    within 1e-6 of the cancelled terms, index swaps only at near-ties, the
    index sets equal where the k-th and (k+1)-th plain distances are
    apart); the launch alone and the call timed by CUDA events beside the
    plain version and the bound; two launches bitwise; the build with FMA
    contraction held the same way and printed beside.  Returns the probe's
    record."""
    import torch

    import icp_scenes
    from feature_base_pointcloud_registration_tpu_torch import kernels
    from feature_base_pointcloud_registration_tpu_torch.ops import (
        knn as tknn)
    q3 = q.reshape(-1, q.shape[-2], 3).contiguous()
    got = tknn.knn(q, ref, mask, k=k, chunk=chunk)
    torch.cuda.synchronize()
    again = tknn.knn(q, ref, mask, k=k, chunk=chunk)
    want = tknn.knn_reference(q, ref, mask, k=k, chunk=chunk)
    wide = tknn.knn_reference(q, ref, mask, k=k + 1, chunk=chunk)[0]

    def agree(res):
        flat = [t.reshape(-1, t.shape[-2], t.shape[-1])
                for t in (*res, *want, wide)]
        refs = ref.reshape(-1, *ref.shape[-2:]).expand(q3.shape[0], -1, -1)
        out = [icp_scenes.knn_agreement(q3[s_], refs[s_], *(t[s_]
                                                             for t in flat))
               for s_ in range(q3.shape[0])]
        return max(e for e, _ in out), sum(n for _, n in out)

    err, swaps = agree(got)
    bitwise = all(map(torch.equal, got, again))
    center = q3.mean(-2)
    d2o = torch.empty(*q3.shape[:2], k, device=q.device)
    io = torch.empty(*q3.shape[:2], k, dtype=torch.int32, device=q.device)
    r3 = ref.reshape(-1, *ref.shape[-2:]) if ref.dim() > 2 else ref
    m2 = mask.reshape(-1, mask.shape[-1]) if mask.dim() > 1 else mask
    ms = cuda_ms(lambda: kernels.launch_knn(q3, center, r3, m2, d2o, io,
                                            one_chunk=ref.shape[-2] == chunk),
                 20, graph=True)
    call_ms = cuda_ms(lambda: tknn.knn(q, ref, mask, k=k, chunk=chunk), 20,
                      graph=True)
    plain_ms = cuda_ms(lambda: tknn.knn_reference(q, ref, mask, k=k,
                                                  chunk=chunk), 3)
    b_ms, b_by = knn_bound(q3, r3, m2, k)
    with launching_with("launch_knn", fma_lib):
        f_err, f_swaps = agree(tknn.knn(q, ref, mask, k=k, chunk=chunk))
    rec = dict(S=q3.shape[0], Q=q3.shape[1], M=ref.shape[-2], k=k,
               chunk=chunk, live=int(mask.sum()), ms=ms, call_ms=call_ms,
               plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
               max_abs_err=err, index_swaps=swaps, bitwise=bitwise,
               fma_max_abs_err=f_err, fma_index_swaps=f_swaps)
    print(f"probe knn {name}: S={rec['S']} Q={rec['Q']} M={rec['M']} "
          f"(live {rec['live']}) k={k} chunk={chunk}: kernel {ms:.4f} ms "
          f"(the call with its centroid {call_ms:.4f}), plain {plain_ms:.3f}"
          f" ms, bound {b_ms:.5f} ms ({b_by}, {b_ms / ms:.2%} of it); d2 "
          f"|diff| max {err:.3e} (within 1e-6 of the cancelled terms), "
          f"index swaps at near-ties {swaps}, no-neighbour slots exact; two "
          f"launches bitwise {bitwise}; the FMA build: d2 |diff| max "
          f"{f_err:.3e}, swaps {f_swaps}", flush=True)
    if not bitwise:
        raise AssertionError(f"knn {name}: two launches differ")
    if KI_AB:
        rec["in_turns"] = lm_turns(
            "knn", name, knn_launcher(q, ref, mask, k, chunk),
            KI_AB["plain"]["knn_stream"], reps=20, flag="--knn-icp-ab",
            graph=True)
        if not rec["in_turns"]["bitwise_other"]:
            raise AssertionError(f"knn {name}: the other version differs")
    return rec


def icp_probe(name, args, kw, fma_lib):
    """One `probe icp` line: the kernel (icp_align on the card, one launch)
    against its plain version on the card (icp_align_reference, the
    parent's loop) and on the CPU, on one recorded run's inputs: transform
    within ICP_TOL (or, where the plain version's own card-vs-CPU spread is
    larger, within twice that spread), converged and the loop closure's
    fitness gate equal, fitness within icp_scenes.fitness_tol, two launches
    bitwise; the kernel and the plain version timed by CUDA events beside
    the bound; the build with FMA contraction printed beside.  Returns the
    probe's record."""
    import torch

    import icp_scenes
    from feature_base_pointcloud_registration_tpu_torch.config import Params
    from feature_base_pointcloud_registration_tpu_torch.ops import (
        icp as ticp)
    got = ticp.icp_align(*args, **kw)
    torch.cuda.synchronize()
    again = ticp.icp_align(*args, **kw)
    want = ticp.icp_align_reference(*args, **kw)
    cpu = ticp.icp_align_reference(*(t.cpu() for t in args), **kw)
    d = float((got.transform - want.transform).abs().max())
    d_cpu = float((want.transform.cpu() - cpu.transform).abs().max())
    tol = max(ICP_TOL, 2.0 * d_cpu)
    f_tol = icp_scenes.fitness_tol(args[0].cpu(), args[1].cpu(),
                                   want.transform.cpu())
    gate = Params().history_keyframe_fitness_score
    bitwise = all(map(torch.equal, got, again))
    ms = cuda_ms(lambda: ticp.icp_align(*args, **kw), 5)
    # no iteration: one 1-NN pass and the fitness, the rest of a run's
    # trips apart
    ms0 = cuda_ms(lambda: ticp.icp_align(*args, **dict(kw, max_iterations=0)),
                  5)
    plain_ms = cuda_ms(lambda: ticp.icp_align_reference(*args, **kw), 2)
    its = int(got.iterations)
    b_ms, b_by = icp_bound(args, its + 1)
    with launching_with("launch_icp", fma_lib):
        fma = ticp.icp_align(*args, **kw)
    d_fma = float((fma.transform - want.transform).abs().max())
    rec = dict(N=args[0].shape[0], M=args[2].shape[0],
               live=(int(args[1].sum()), int(args[3].sum())),
               max_corr_dist=kw.get("max_corr_dist", 100.0),
               iterations=its, plain_iterations=int(want.iterations),
               cpu_iterations=int(cpu.iterations),
               fitness=float(got.fitness), plain_fitness=float(want.fitness),
               converged=bool(got.converged), ms=ms, plain_ms=plain_ms,
               no_iteration_ms=ms0, trip_ms=(ms - ms0) / max(its, 1),
               bound_ms=b_ms, bound_by=b_by, max_abs_err=d,
               plain_card_vs_cpu_err=d_cpu, bitwise=bitwise,
               fma_max_abs_err=d_fma, fma_iterations=int(fma.iterations))
    print(f"probe icp {name}: N={rec['N']} M={rec['M']} live {rec['live']}"
          f" max_corr_dist {rec['max_corr_dist']}: kernel {ms:.3f} ms "
          f"({its} iterations, delta {float(got.delta):.3e}; with none, the "
          f"1-NN pass and the fitness, {ms0:.4f} ms: {rec['trip_ms']:.4f} ms"
          f" an iteration), plain "
          f"{plain_ms:.2f} ms ({rec['plain_iterations']} iterations; on the "
          f"CPU {rec['cpu_iterations']}), bound {b_ms:.5f} ms ({b_by}, "
          f"{b_ms / ms:.2%} of it); transform |diff| {d:.3e} (the plain "
          f"version card vs CPU {d_cpu:.3e}; held to {tol:.1e}); fitness "
          f"{rec['fitness']:.7g} vs {rec['plain_fitness']:.7g} (held to "
          f"{f_tol:.2e}), converged {rec['converged']} vs "
          f"{bool(want.converged)}; two launches bitwise {bitwise}; the FMA "
          f"build: transform |diff| {d_fma:.3e}, {rec['fma_iterations']} "
          f"iterations", flush=True)
    if not (d <= tol and bool(got.converged) == bool(want.converged)
            and (rec["fitness"] < gate) == (rec["plain_fitness"] < gate)
            and abs(rec["fitness"] - rec["plain_fitness"]) <= f_tol
            and bitwise):
        raise AssertionError(f"icp {name}: kernel != plain version")
    launch = icp_launcher(args, kw)
    if not KI_PROFILE:
        KI_PROFILE.update(ab_builds(("icp",), profile="-DFBPR_ICP_PROFILE"))
    rec["split"] = icp_split(name, launch, KI_PROFILE["icp"],
                             "diagnostic build")
    # the bound of the keys the cell search computed (the brute force's
    # pairs are the bound above, kept so that rows compare across PRs)
    rec["bound_visited_ms"], rec["bound_visited_by"] = bound(
        13 * (rec["N"] + rec["M"]) + 80,
        KNN_OPS_PAIR * rec["split"]["keys_trip"] * (its + 1)
        + ICP_OPS_ROW * rec["N"] * (its + 1))
    print(f"probe icp {name}: the keys the cell search computed, "
          f"{rec['split']['keys_trip']:.0f} a trip of "
          f"{rec['live'][0] * rec['live'][1]} live pairs: bound "
          f"{rec['bound_visited_ms']:.5f} ms ({rec['bound_visited_by']}, "
          f"{rec['bound_visited_ms'] / ms:.2%} of the kernel)", flush=True)
    if KI_AB:
        rec["in_turns"] = lm_turns("icp", name, launch,
                                   KI_AB["plain"]["icp"], reps=5,
                                   flag="--knn-icp-ab")
        rec["other_split"] = icp_split(
            name, launch, KI_AB["profile"]["icp"],
            "the other version's diagnostic build")
        if not rec["in_turns"]["bitwise_other"]:
            raise AssertionError(f"icp {name}: the other version differs")
    return rec


def knn_icp_probes(dev):
    """The `probe knn` lines at (a) ICP's phase 8 shape (its loop
    candidates' source against their submap, k 1), (b) FPFH's (phase 10
    (c)'s first pair's target cloud in itself, k 16, 2048 points), (c) the
    exact solver's surf map (phase 8's first checked registration, k 5);
    the `probe icp` lines at (a) phase 8's loop candidates, (b) phase 10
    (c)'s first pair, (c) phase 10 (d)'s merge; their inputs kept in
    build/knn_icp_inputs.pt.  Returns ({name: knn record}, {name: icp
    record})."""
    import torch

    from feature_base_pointcloud_registration_tpu_torch import kernels
    knn_lib, icp_lib = fma_build("knn_stream"), fma_build("icp")
    (src, _, dst, dst_m), kw = ICP_INPUTS["(a) phase 8 loop candidates"]
    (_, _, pd, pd_m), pkw = ICP_INPUTS["(b) phase 10 (c) pair"]
    knn_rec = {
        "(a) ICP phase 8": knn_probe("(a) ICP phase 8", src, dst, dst_m, 1,
                                     kw.get("chunk", 2048), knn_lib),
        "(b) FPFH phase 10 (c)": knn_probe(
            "(b) FPFH phase 10 (c)", pd, pd, pd_m, 16,
            pkw.get("chunk", 2048), knn_lib)}
    a, kw = KNN_INPUTS["(c) exact solver surf map"]
    knn_rec["(c) exact solver"] = knn_probe("(c) exact solver", *a[:3],
                                            kw["k"], kw["chunk"], knn_lib)
    icp_rec = {name: icp_probe(name, a, kw, icp_lib)
               for name, (a, kw) in ICP_INPUTS.items()}
    # the inputs, for scripts/knn_icp_turns.py
    torch.save({kind: {n: ([t.cpu() for t in a], kw)
                       for n, (a, kw) in inputs.items()}
                for kind, inputs in (("icp", ICP_INPUTS),
                                     ("knn", KNN_INPUTS))},
               os.path.join(kernels.BUILD_DIR, "knn_icp_inputs.pt"))
    return knn_rec, icp_rec


# the exact solver's solves on the exact_gn kernel: phase 8's inputs
# (((pose, features, local map), exact_kw), ...), phase 8's solves in turns
EXACT_INPUTS = []
EXACT_TURNS = {}
# m / rad: exact_gn vs its plain loop, agreeing lanes.  Set from readings
# (H100 80GB HBM3, 700 W): with the first iteration's 5-NN bitwise the
# plain loop's, phase 8's solves read up to 1.651e-5, 32 bench lanes
# 2.901e-5, a 16384-slot dense map (tests/test_torch_kernels_cuda.py)
# 2.73e-5: the fits' arithmetic differs from the plain loop's, and a
# correspondence at a gate that goes the other way in one iteration moves
# a solve by that much (the plain loop's own card-vs-CPU runs by up to
# 5.3e-6); about three times the largest reading
EXACT_TOL = 1e-4
EXACT_DEG_TOL = 1e-3     # the same on degenerate lanes (Jacobi vs eigh frame)
# (m, rad): one GN step under the convergence thresholds (0.05 cm, 0.05
# deg), what a lane whose stop moved by an iteration may differ by where the
# plain loop's own card-vs-CPU spread is smaller
EXACT_STEP = (5e-4, 0.05 * np.pi / 180)
N_EXACT_BATCH = 32       # probe exact_gn (b): lanes of the bench batch
EXACT_DENSE = 65536      # probe exact_gn (c): surf slots, every one live


def exact_kw(params):
    """exact_gn's keywords at a Params' settings (register_scan_with_params'
    call)."""
    return dict(iters=params.max_gn_iterations,
                min_corr=params.min_correspondences,
                eig_thresh=params.degeneracy_eigen_threshold,
                edge_min_valid=params.edge_feature_min_valid_num,
                surf_min_valid=params.surf_feature_min_valid_num,
                chunk=params.knn_chunk,
                conv_rot_deg=params.converge_delta_rot_deg,
                conv_trans_cm=params.converge_delta_trans_cm)


def exact_bound(feats, local_map, stat):
    """(bound_ms, bound_by) of one exact solve that ended at stat [B, 16]:
    a lane-iteration reads the map's slots (16 B a slot) and does 2 * 3 * Q
    * M operations (Q live features, M live map points of each kind)."""
    its = stat[:, 6].double().cpu()
    q = [f.sum(1).double().cpu() for f in (feats.corner_mask,
                                            feats.surf_mask)]
    m = [f.sum(-1).double().cpu() for f in (local_map.corner_mask,
                                             local_map.surf_mask)]
    slots = local_map.corner_xyz.shape[-2] + local_map.surf_xyz.shape[-2]
    return bound(float((its * slots * 16).sum()),
                 float((its * 6 * (q[0] * m[0] + q[1] * m[1])).sum()))


def exact_first_nn(pose, feats, local_map, kw):
    """exact_scenes.first_nn_agreement of the kernel's first iteration (one
    launch at iters=1 with its diagnostic output) against ops/knn.py::knn
    at pose."""
    import torch

    import exact_scenes
    from feature_base_pointcloud_registration_tpu_torch import kernels
    B, dev = pose.shape[0], pose.device
    P = feats.corner_xyz.shape[1] + feats.surf_xyz.shape[1]
    nn = (torch.full((B, P, 5), -2, dtype=torch.int32, device=dev),
          torch.zeros(B, P, 5, device=dev))
    stat = torch.empty(B, 16, device=dev)
    kernels.launch_exact_gn(pose, feats, local_map, stat, nn=nn,
                            **dict({k: v for k, v in kw.items()
                                    if k != "chunk"}, iters=1))
    return exact_scenes.first_nn_agreement(
        pose, feats, local_map, nn, stat[:, 9].cpu().numpy() > 0,
        kw["chunk"])


def exact_plain_split(inputs, kw):
    """The plain loop (exact_gn_reference: the parent's register_scan
    route, register_core on knn_stream.cu) on one solve's inputs, split by
    stage on a synchronized host clock (a sync before and after each stage
    call): the 5-NN (knn5_points, a corner and a surf call an iteration),
    the fits around it (corner_ and surf_correspondence less their 5-NN),
    gn_step (its torch.linalg.eigh inside), and the rest (world points, the
    lanes' freeze, the host's check of `active` an iteration); then the
    same solve under torch.profiler (profile_call).  Returns dict(solve_ms,
    iterations, per-iteration ms by stage, profile)."""
    import torch

    from feature_base_pointcloud_registration_tpu_torch.ops import (
        exact_gn as tex, knn as tknn, register as treg)
    pose, feats, local_map = inputs
    spent = {"knn": 0.0, "fits": 0.0, "gn_step": 0.0}

    def timed(fn, key):
        def f(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            spent[key] += (time.perf_counter() - t0) * 1e3
            return out
        return f

    names = ((treg, "corner_correspondence", "fits"),
             (treg, "surf_correspondence", "fits"),
             (treg, "gn_step", "gn_step"), (tknn, "knn5_points", "knn"))
    real = [getattr(mod, n) for mod, n, _ in names]
    for (mod, n, key), fn in zip(names, real):
        setattr(mod, n, timed(fn, key))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stat = tex.exact_gn_reference(pose, feats, local_map, **kw)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    finally:
        for (mod, n, _), fn in zip(names, real):
            setattr(mod, n, fn)
    its = max(int(stat[:, 6].max()), 1)
    spent["fits"] -= spent["knn"]
    spent["rest"] = wall - sum(spent.values())
    wall_p, busy, top = profile_call(
        lambda: tex.exact_gn_reference(pose, feats, local_map, **kw))
    return dict(solve_ms=wall, iterations=its,
                iteration_ms={k: v / its for k, v in spent.items()},
                profile=dict(wall_ms=wall_p, device_busy_ms=busy,
                             top=[(n[:60], ms) for n, ms in top[:6]]))


def exact_probe(name, inputs, kw, cpu_lanes, strict=False, oracle=None):
    """One `probe exact_gn` line: the kernel (exact_gn) against its plain
    loop (exact_gn_reference) on the card and, on the lanes cpu_lanes and
    every flipped one (up to 4), on the CPU, on the same inputs (pose,
    features, local map); kernel and plain ms by CUDA events, the bound;
    the first iteration's neighbours against knn (exact_first_nn: no
    index swap, d2 |diff| 0); two launches bitwise.  A lane whose iterations, n_corr and flags agree
    with the plain loop's on the card is held to EXACT_TOL in pose
    (EXACT_DEG_TOL where degenerate); when not strict, to twice the plain
    loop's own card-vs-CPU spread (pose on the CPU lanes whose flags agree
    across devices) where that is larger (as rounds_probe holds rounds_gn:
    a neighbour at a near-tie or a point at a gate moves a solve by as
    much on float32 rounding alone).  The spread is printed either way.
    The other lanes ("flips") are counted, none allowed when strict, and
    else each held, with its iterations at most one apart, to that spread
    on it or one GN step under the convergence thresholds (EXACT_STEP),
    whichever is larger.  oracle: (poses [n, 6]
    of tests/oracle.py): the kernel's ate_vs_oracle_m over the first n
    lanes, held to PARITY_BUDGET.  Returns the record, with `failed` set
    where a hold fails."""
    import torch

    from feature_base_pointcloud_registration_tpu_torch import kernels
    from feature_base_pointcloud_registration_tpu_torch.ops import (
        exact_gn as tex)
    pose, feats, local_map = inputs

    def kernel():
        return tex.exact_gn(pose, feats, local_map, **kw)

    def plain():
        return tex.exact_gn_reference(pose, feats, local_map, **kw)

    sk = kernel()
    sr = plain()
    B = sk.shape[0]
    same = (sk[:, 6:11] == sr[:, 6:11]).all(1)
    dpose = (sk[:, :6] - sr[:, :6]).abs().max(1).values
    deg = sr[:, 8] > 0
    flips = torch.nonzero(~same)[:, 0].tolist()
    lanes = sorted(set(cpu_lanes) | set(flips[:4]))
    sub = type(feats)(*(t[lanes].cpu() for t in feats))
    lmap = type(local_map)(*(   # a one-a-lane map: those lanes'
        (t[lanes] if t.dim() == 3 - i % 2 else t).cpu()
        for i, t in enumerate(local_map)))
    sc = tex.exact_gn_reference(pose[lanes].cpu(), sub, lmap,
                                **kw).to(sr.device)
    same_c = (sc[:, 6:11] == sr[lanes, 6:11]).all(1)
    dpose_c = (sc[:, :6] - sr[lanes, :6]).abs().max(1).values

    def worst(d, m):
        return float(d[m].max()) if bool(m.any()) else 0.0

    spread = worst(dpose_c, same_c)
    tol = EXACT_TOL if strict else max(EXACT_TOL, 2.0 * spread)
    deg_tol = EXACT_DEG_TOL if strict else max(EXACT_DEG_TOL, 2.0 * spread)
    err, err_deg = worst(dpose, same & ~deg), worst(dpose, same & deg)
    bitwise = torch.equal(kernel(), sk)
    ms = cuda_ms(kernel, 5)
    plain_ms = cuda_ms(plain, 1)
    b_ms, b_by = exact_bound(feats, local_map, sr)
    nn = exact_first_nn(pose, feats, local_map, kw)
    Pc, Ps = feats.corner_xyz.shape[1], feats.surf_xyz.shape[1]
    index = pose.device.index or 0
    C = kernels.exact_gn_cluster(
        B, Pc + Ps, kernels._sm_count(index),
        lambda c: kernels.exact_gn_max_clusters(index, c))
    its = sr[:, 6].long()
    rec = dict(B=B, Pc=Pc, Ps=Ps, Mc=local_map.corner_xyz.shape[-2],
               Ms=local_map.surf_xyz.shape[-2],
               live_features=[int(feats.corner_mask.sum()),
                              int(feats.surf_mask.sum())],
               live_map=[int(local_map.corner_mask.sum()),
                         int(local_map.surf_mask.sum())],
               cluster=C, lane_iterations=int(its.sum()),
               max_iterations=int(its.max()), degenerate=int(deg.sum()),
               flips=len(flips), equal_lanes=float(same.float().mean()),
               max_abs_err=err, degenerate_err=err_deg, held_to=tol,
               plain_card_vs_cpu_err=spread,
               plain_card_vs_cpu_lanes=len(lanes),
               plain_card_vs_cpu_equal=float(same_c.float().mean()),
               ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
               bitwise=bitwise, index_swaps=nn["swaps"],
               nn_slots=nn["slots"], nn_d2_err=nn["d2_err"])
    held = []
    for b in flips:
        dt = float((sk[b, 3:6] - sr[b, 3:6]).abs().max())
        dr = float((sk[b, 0:3] - sr[b, 0:3]).abs().max())
        own = float(dpose_c[lanes.index(b)]) if b in lanes else 0.0
        ht, hr = max(EXACT_STEP[0], own), max(EXACT_STEP[1], own)
        held.append(not strict and dt <= ht and dr <= hr
                    and abs(int(sk[b, 6]) - int(sr[b, 6])) <= 1)
        print(f"probe exact_gn {name}: FLIP lane {b}: iterations "
              f"{int(sk[b, 6])} vs {int(sr[b, 6])}, n_corr {int(sk[b, 10])}"
              f" vs {int(sr[b, 10])}, converged {int(sk[b, 7])} vs "
              f"{int(sr[b, 7])}, degenerate {int(sk[b, 8])} vs "
              f"{int(sr[b, 8])}, pose |diff| {dt:.3e} m {dr:.3e} rad; the "
              f"plain loop card vs CPU on it {own:.3e} (held to {ht:.3e} m "
              f"{hr:.3e} rad{', none allowed here' if strict else ''})",
              flush=True)
    if oracle is not None:
        n = len(oracle)
        d = sk[:n, 3:6].cpu().numpy() - oracle[:, 3:]
        rec["ate_vs_oracle_m"] = float(np.sqrt((d ** 2).sum(-1).mean()))
        d = sr[:n, 3:6].cpu().numpy() - oracle[:, 3:]
        rec["plain_ate_vs_oracle_m"] = float(np.sqrt((d ** 2).sum(-1)
                                                     .mean()))
    print(f"probe exact_gn {name}: B={B} Pc={Pc} Ps={Ps} Mc={rec['Mc']} "
          f"Ms={rec['Ms']} live features {rec['live_features']} live map "
          f"{rec['live_map']} cluster {C}: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.3f} ms, bound {b_ms:.5f} ms ({b_by}, "
          f"{b_ms / ms:.2%} of it); lane-iterations {rec['lane_iterations']} "
          f"(max {rec['max_iterations']}); pose |diff| max {err:.3e} on "
          f"{int((same & ~deg).sum())} agreeing lanes; degenerate lanes "
          f"{rec['degenerate']}, pose |diff| {err_deg:.3e}; iterations, "
          f"n_corr and flags equal on {rec['equal_lanes']:.4f} of lanes "
          f"({len(flips)} flips); the plain loop on the card against it on "
          f"the CPU on {len(lanes)} lanes: equal on "
          f"{rec['plain_card_vs_cpu_equal']:.4f}, pose |diff| max "
          f"{spread:.3e} on agreeing lanes; held to {tol:.3e}; first "
          f"iteration's neighbours: {nn['slots']} slots, index swaps at "
          f"near-ties {nn['swaps']}, d2 |diff| max {nn['d2_err']:.3e}, held "
          f"{nn['ok']}"
          + (f"; ate_vs_oracle_m {rec['ate_vs_oracle_m']} (the plain loop "
             f"{rec['plain_ate_vs_oracle_m']})" if oracle is not None
             else "") + f"; two launches bitwise {bitwise}", flush=True)
    # the centroid in ATen's order: the first iteration's 5-NN bit for bit
    if not (err <= tol and err_deg <= deg_tol and all(held) and bitwise
            and nn["ok"] and nn["swaps"] == 0 and nn["d2_err"] == 0.0):
        rec["failed"] = (f"exact_gn {name}: pose {err} (held to {tol}), "
                         f"degenerate {err_deg}, flips held {held}, bitwise "
                         f"{bitwise}, neighbours {nn}")
    if oracle is not None and not rec["ate_vs_oracle_m"] <= PARITY_BUDGET:
        rec["failed"] = (f"exact_gn {name}: ate_vs_oracle_m "
                         f"{rec['ate_vs_oracle_m']}")
    return rec


def exact_probes(dev, bench):
    """The `probe exact_gn` lines: (a) phase 8's three exact solves (no
    flip allowed there; each solve's plain loop also on the CPU), (b)
    parallel/batch.py::batch_register on the bench
    batch's first N_EXACT_BATCH scans and its shared map (one exact_gn
    launch; ate_vs_oracle_m on the first N_ORACLE lanes; the plain loop on
    the CPU on lanes 0, 1 and the flipped ones), (c) the bench's
    scan 0 on a surf map of EXACT_DENSE slots, every one live (the room's
    surf points at 0.25 m, a seeded subset).  Every line prints before a
    failed hold raises.  Returns {name: record}."""
    import torch

    from feature_base_pointcloud_registration_tpu_torch.config import Params
    from feature_base_pointcloud_registration_tpu_torch.io.synthetic import (
        SyntheticWorld)
    from feature_base_pointcloud_registration_tpu_torch.ops import (
        exact_gn as tex)
    from feature_base_pointcloud_registration_tpu_torch.parallel.batch import (
        batch_register)
    rec = {}
    for n, (inputs, kw) in enumerate(EXACT_INPUTS):
        rec[f"(a) phase 8 solve {n}"] = exact_probe(
            f"(a) phase 8 solve {n}", inputs, kw, [0], strict=True)
    kw = exact_kw(Params())
    lanes = slice(0, N_EXACT_BATCH)
    feats = type(bench.feats)(*(t[lanes] for t in bench.feats))
    guesses = bench.guesses[lanes]
    before = tex.exact_gn.launches
    res = batch_register(feats, bench.fmap, guesses, chunk=kw["chunk"])
    torch.cuda.synchronize()
    launches = tex.exact_gn.launches - before
    name = f"(b) batch_register B={N_EXACT_BATCH}"
    rec[name] = exact_probe(name, (guesses, feats, bench.fmap), kw, [0, 1],
                            oracle=bench.oracle_poses)
    same = torch.equal(res.pose6, tex.exact_gn(guesses, feats, bench.fmap,
                                               **kw)[:, :6])
    rec[name].update(launches=launches, entry_point_bitwise=same)
    print(f"probe exact_gn {name}: {launches} exact_gn launch through "
          f"batch_register, its poses bitwise the probe's {same}",
          flush=True)
    if launches != 1 or not same:
        raise AssertionError(f"exact_gn (b): {launches} launches, bitwise "
                             f"{same}")
    pts = SyntheticWorld().surf_map_points(0.25)
    pick = np.random.RandomState(0).choice(len(pts), EXACT_DENSE,
                                           replace=False)
    dense = type(bench.fmap)(
        bench.fmap.corner_xyz, bench.fmap.corner_mask,
        torch.from_numpy(np.ascontiguousarray(pts[np.sort(pick)])).to(dev),
        torch.ones(EXACT_DENSE, dtype=torch.bool, device=dev))
    name = f"(c) a fully live {EXACT_DENSE}-slot surf map"
    rec[name] = exact_probe(
        name, (bench.guesses[:1], type(bench.feats)(
            *(t[:1] for t in bench.feats)), dense), kw, [0])
    failed = [r["failed"] for r in rec.values() if "failed" in r]
    if failed:
        raise AssertionError("; ".join(failed))
    return rec


def sync_counter(fn, counts):
    """fn wrapped: the host syncs of each call (warnings of the CUDA sync
    debug mode, not its one-time notice that the mode is a prototype)
    appended to counts."""
    import warnings

    import torch

    def counted(*a, **kw):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                return fn(*a, **kw)
            finally:
                torch.cuda.set_sync_debug_mode("default")
                counts.append(sum("synchroniz" in str(w.message)
                                  and "prototype" not in str(w.message)
                                  for w in caught))
    return counted


def frontend_split(params, items, dev):
    """The frontend's stages with the picking on the kernel and on its plain
    version, in turns (kernel, plain, plain, kernel), over items [(scan,
    deskew table on the CPU or None)]: {route: means of [projection +
    deskew, ring windows, picking, voxel thinning and compaction (the rest
    of extract_features and downsample_features), the frontend
    (process_scan's calls), all device ms by CUDA events; the frontend's
    host ms (synchronized); the picking's host syncs (sync debug mode)]}."""
    import torch

    from feature_base_pointcloud_registration_tpu_torch.ops import features
    from feature_base_pointcloud_registration_tpu_torch.ops.projection import (
        project_scan)
    from feature_base_pointcloud_registration_tpu_torch.pipeline.cloud_info import (  # noqa: E501
        DeskewInfo)
    from feature_base_pointcloud_registration_tpu_torch.pipeline.frontend import (  # noqa: E501
        downsample_features)

    out = {"kernel": [], "plain": []}
    for route in ("kernel", "plain", "plain", "kernel"):
        with picking_route(route):
            for s, dsk_cpu in items:
                raw = raw_of(s, dev, batch=True)
                dsk = (None if dsk_cpu is None else
                       DeskewInfo(*(a.to(dev) for a in dsk_cpu)))
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
                syncs = []
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                ev[0].record()
                cloud = project_scan(params, raw, dsk)
                ev[1].record()
                downsample_features(params, features.extract_features(
                    params, cloud, strict=params.strict_feature_pick))
                ev[2].record()
                torch.cuda.synchronize()
                host = (time.perf_counter() - t0) * 1e3
                win = features._ring_windows(cloud, params.n_scan,
                                             params.horizon_scan)
                ev[3].record()
                sync_counter(features._pick, syncs)(
                    win, params.edge_threshold, params.surf_threshold,
                    params.strict_feature_pick)
                ev[4].record()
                torch.cuda.synchronize()
                proj, rest, pick = (ev[0].elapsed_time(ev[1]),
                                    ev[1].elapsed_time(ev[2]),
                                    ev[3].elapsed_time(ev[4]))
                t_win = cuda_ms(lambda: features._ring_windows(
                    cloud, params.n_scan, params.horizon_scan), 3)
                out[route].append([proj, t_win, pick, rest - t_win - pick,
                                   proj + rest, host, syncs[0]])
    return {r: np.mean(v, axis=0) for r, v in out.items()}


def print_frontend_split(phase, split):
    for route, v in split.items():
        name = ("the kernel" if route == "kernel" else
                "its plain version (the parent's route)")
        print(f"time {phase} frontend, picking on {name}: frontend "
              f"{v[4]:.3f} ms device, {v[5]:.3f} ms host; projection + "
              f"deskew {v[0]:.3f} ms, ring windows {v[1]:.3f} ms, picking "
              f"{v[2]:.3f} ms, voxel thinning and compaction {v[3]:.3f} ms; "
              f"host syncs in picking {v[6]:.1f}", flush=True)


def ring_pick_bound(win):
    """(bound_ms, bound_by) of one ring_pick call: the windows' curv, col,
    picked and sector bounds read once and the labels written once; as
    operations, this run's sectors' bitonic compare-exchanges and walk
    steps (the serial walk, which sets the kernel's floor, is latency, not
    either)."""
    import torch
    W = win["curv"].shape[-1]
    n_slots = win["curv"].numel()
    n_win = n_slots // W
    nbytes = n_slots * (4 + 4 + 1 + 1) + n_win * 6 * (4 + 4 + 1)
    lo = win["sp"].clamp(min=0).long()
    hi = win["ep"].long().clamp(max=W - 1)
    n = torch.where(win["sector_ok"] & (hi >= lo), hi - lo + 1, 0).cpu()
    logn = torch.ceil(torch.log2(n.clamp(min=1).double()))
    ops = float((2 ** logn / 2 * logn * (logn + 1) / 2 + 2 * n).sum())
    return bound(nbytes, ops)


def ring_pick_profile_build():
    """ring_pick.cu's diagnostic build: -DFBPR_RING_PICK_PROFILE adds
    clock64 stamps and fbpr_ring_pick_profile; loaded."""
    return variant_build("ring_pick", ["-DFBPR_RING_PICK_PROFILE"],
                         "ring_pick (diagnostic build)")


def launch_pick(lib, win, edge, surf, strict):
    """One fbpr_ring_pick launch of the build `lib` on windows `win` (as
    ring_pick validates them): the labels."""
    import torch

    from feature_base_pointcloud_registration_tpu_torch import kernels
    curv = win["curv"]
    W = curv.shape[-1]
    label = torch.empty(curv.shape, dtype=torch.int8, device=curv.device)
    kernels._check_rc("fbpr_ring_pick", lib.fbpr_ring_pick(
        *(win[k].data_ptr() for k in ("curv", "col", "picked", "sp", "ep",
                                      "sector_ok")),
        curv.numel() // W, W, edge, surf, int(strict), label.data_ptr(),
        kernels._stream(curv)))
    return label


def ring_pick_split(name, shape, lib, reps=5):
    """One `probe ring_pick ... split` line: reps launches of a diagnostic
    build (ring_pick_profile_build) on the shape's windows, their labels
    checked against the plain version, and a window's parts from the
    clock64 sums on thread 0 of each CTA, in us a window (cycles over the
    clock that the kernel's own clock64 and globaltimer give), summed over
    the window's sectors: the load, the sorts (with the lists' compaction),
    the corner walks, the surf walks (0 in fast mode) and the tail (the
    label write, and the wait for the other warps).  Thread 0 sees the
    parts it runs or waits for: in fast mode its warp sorts and walks
    sector 0 while the other warps do theirs; in strict mode "sorts" is
    its own sector's and its waits for the others'.  A build that stamps
    each warp's lists also gives a sector's compaction and sort.  Returns
    the record."""
    import ctypes

    import torch

    from feature_base_pointcloud_registration_tpu_torch import kernels
    from feature_base_pointcloud_registration_tpu_torch.ops.features import (
        ring_pick_reference)
    win, edge, surf, strict = shape
    out = (ctypes.c_uint64 * 11)()
    torch.cuda.synchronize()
    kernels._check_rc("fbpr_ring_pick_profile", lib.fbpr_ring_pick_profile(
        ctypes.addressof(out), 1))
    for _ in range(reps):
        got = launch_pick(lib, win, edge, surf, strict)
    torch.cuda.synchronize()
    kernels._check_rc("fbpr_ring_pick_profile", lib.fbpr_ring_pick_profile(
        ctypes.addressof(out), 1))
    if not torch.equal(got, ring_pick_reference(win, edge, surf, strict)):
        raise AssertionError(f"ring_pick diagnostic build at {name} != its "
                             "plain version")
    (ctas, load, sort, corner, surf_, tail, cycles, ns, sectors, compact,
     sorts) = (int(v) for v in out)
    ghz = cycles / max(ns, 1)
    parts = {k: v / max(ctas, 1) / ghz / 1e3 for k, v in (
        ("load_us", load), ("sort_us", sort), ("corner_us", corner),
        ("surf_us", surf_), ("tail_us", tail))}
    total = sum(parts.values())
    rec = dict(parts, window_us=total, kernel_us=ns / max(ctas, 1) / 1e3,
               ghz=ghz, windows=ctas // reps)
    if sectors:      # a sector's lists on their warp (the redesign's build)
        rec.update(sector_compaction_us=compact / sectors / ghz / 1e3,
                   sector_sort_us=sorts / sectors / ghz / 1e3)
    print(f"probe ring_pick {name} split (diagnostic build, clock64 on "
          f"thread 0 of each CTA, {rec['windows']} windows, clock "
          f"{ghz:.3f} GHz): a window {total:.2f} us = load "
          f"{parts['load_us']:.2f} ({parts['load_us'] / total:.1%}), sorts "
          f"{parts['sort_us']:.2f} ({parts['sort_us'] / total:.1%}), corner "
          f"walks {parts['corner_us']:.2f} "
          f"({parts['corner_us'] / total:.1%}), surf walks "
          f"{parts['surf_us']:.2f} ({parts['surf_us'] / total:.1%}), tail "
          f"{parts['tail_us']:.2f} ({parts['tail_us'] / total:.1%}); "
          f"the kernel {rec['kernel_us']:.2f} us a CTA" + (
              f"; a sector's lists on its warp: compaction "
              f"{rec['sector_compaction_us']:.2f} us, sort "
              f"{rec['sector_sort_us']:.2f} us" if sectors else ""),
          flush=True)
    return rec


def ring_pick_shapes(dev, params, raw, loc_scan, loc_dsk):
    """The ring-pick probe shapes {name: (windows, edge, surf, strict)}:
    (a) phase 7's VLP-16 scan (B=1, strict; `loc_scan` with its deskew
    table `loc_dsk`, or None), (b) the bench batch (`raw`, B=256, fast), (c)
    kitti_mini's HDL-64 scans (B=3) and a 64-ring scan of the synthetic
    world (strict), (d) tests/pick_windows.py's windows (ties, flat runs,
    ramps, pre-suppressed points, uneven sectors, the first-20 cap, signed
    zeros, the walk's step edges, lists past 512) in both modes, each a
    batch of windows."""
    import pick_windows
    import torch

    from feature_base_pointcloud_registration_tpu_torch.config import Params
    from feature_base_pointcloud_registration_tpu_torch.io import kitti
    from feature_base_pointcloud_registration_tpu_torch.ops.features import (
        _ring_windows)
    from feature_base_pointcloud_registration_tpu_torch.ops.projection import (
        project_scan)
    from feature_base_pointcloud_registration_tpu_torch.pipeline.cloud_info import (  # noqa: E501
        DeskewInfo, RawScan)

    def windows_of(p, raw_b, dsk=None):
        return _ring_windows(project_scan(p, raw_b, dsk), p.n_scan,
                             p.horizon_scan)

    def stacked(ws):
        return {k: torch.from_numpy(np.stack([np.asarray(w[k]) for w in ws]))
                [None].to(dev) for k in ws[0]}

    p7, hdl64 = Params(), Params(n_scan=64, horizon_scan=1800)
    vdir = os.path.join(REPO, "tests", "data", "kitti_mini",
                        "velodyne_points", "data")
    kitti_raw = RawScan(*(torch.stack(a) for a in zip(*(
        kitti.load_scan(f, 1 << 17, device=dev)
        for f in kitti.scan_files(vdir)))))
    stride = stacked([pick_windows.stride_window(t)
                      for t in range(pick_windows.N_STRIDE)])
    shapes = {
        "(a) phase 7 VLP-16 B=1 strict": (windows_of(
            p7, raw_of(loc_scan, dev, batch=True),
            None if loc_dsk is None else DeskewInfo(*(a.to(dev)
                                                      for a in loc_dsk))),
            p7.edge_threshold, p7.surf_threshold, True),
        "(b) bench B=256 fast": (windows_of(params, raw),
                                 params.edge_threshold,
                                 params.surf_threshold, False),
        "(c) kitti_mini HDL-64 B=3 strict": (windows_of(
            hdl64, kitti_raw), hdl64.edge_threshold, hdl64.surf_threshold,
            True),
        "(c) synthetic HDL-64 B=1 strict": (windows_of(
            hdl64, raw_of(pick_windows.hdl64_scan(0), dev, batch=True)),
            hdl64.edge_threshold, hdl64.surf_threshold, True)}
    for strict in (True, False):
        mode = "strict" if strict else "fast"
        shapes.update({
            f"(d) stream windows {mode}": (stacked(
                pick_windows.stream_windows()), 1.0, 0.1, strict),
            f"(d) stride windows {mode}": (stride, 0.05, 0.1, strict),
            f"(d) stride windows, every slot a corner candidate {mode}": (
                stride, -1.0, 0.1, strict),
            f"(d) gap windows {mode}": (stacked(
                [pick_windows.gap_window(t)
                 for t in range(pick_windows.N_GAP)]), 1.0, 0.1, strict),
            f"(d) edge windows {mode}": (stacked(
                [pick_windows.edge_window(t)
                 for t in range(pick_windows.N_EDGE)]), 1.0, 0.1, strict)})
    return shapes


def ring_pick_probes(shapes, prof=None):
    """Probe lines of the ring-pick kernel: at each named shape {name:
    (windows, edge, surf, strict)} its labels against its plain version on
    the same windows (bitwise), both timed by CUDA events (the kernel also
    through a replayed CUDA graph of its calls, `graph_ms`, since a call
    at B=1 is not much longer than its host launch), with the bound; with
    the diagnostic build `prof`, the split at (a)-(c).  Returns {name:
    {windows, W, strict, equal, max_abs_err, ms, graph_ms, plain_ms,
    bound_ms, bound_by[, split]}}; raises if the kernel and its plain
    version differ anywhere."""
    import torch

    from feature_base_pointcloud_registration_tpu_torch.ops.features import (
        ring_pick, ring_pick_reference)
    out = {}
    for name, (win, edge, surf, strict) in shapes.items():
        got = ring_pick(win, edge, surf, strict)
        torch.cuda.synchronize()
        want = ring_pick_reference(win, edge, surf, strict)
        err = int((got.int() - want.int()).abs().max())
        ms = cuda_ms(lambda: ring_pick(win, edge, surf, strict), 20)
        graph_ms = cuda_ms(lambda: ring_pick(win, edge, surf, strict), 20,
                           graph=True)
        plain_ms = cuda_ms(lambda: ring_pick_reference(win, edge, surf,
                                                       strict), 2)
        b_ms, b_by = ring_pick_bound(win)
        W = win["curv"].shape[-1]
        out[name] = dict(windows=win["curv"].numel() // W, W=W,
                         strict=strict, equal=torch.equal(got, want),
                         max_abs_err=err, ms=ms, graph_ms=graph_ms,
                         plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                         corners=int((want == 1).sum()),
                         surfs=int((want == -1).sum()))
        print(f"probe ring_pick {name}: {out[name]}", flush=True)
        if prof is not None and name[:3] in ("(a)", "(b)", "(c)"):
            out[name]["split"] = ring_pick_split(
                name, (win, edge, surf, strict), prof)
    bad = [n for n, r in out.items() if not r["equal"]]
    if bad:
        raise AssertionError(f"ring_pick kernel != its plain version: {bad}")
    return out


def localization_phase(dev):
    """Phase 7: the single-scan localization pipeline on the card at the
    reference's settings (default Params).  Returns (launches {wrapper:
    count} over the N_LOC steps, {feature kind: (kernel, ms, plain_ms,
    bound_ms, bound_by)} of the fetch at step 0's queries, {kernel:
    max_abs_err} of the checked fetches, the first N_DENSE steps' inputs
    and poses [(scan, ground truth, time, deskew table on the CPU, pose)]
    for phase 7 (h))."""
    import torch

    from feature_base_pointcloud_registration_tpu_torch import kernels
    from feature_base_pointcloud_registration_tpu_torch.config import Params
    from feature_base_pointcloud_registration_tpu_torch.geom.se3 import (
        euler_from_quat, rot_to_euler)
    from feature_base_pointcloud_registration_tpu_torch.imu.conversion import (
        imu_converter)
    from feature_base_pointcloud_registration_tpu_torch.io.pcd import (
        write_pcd)
    from feature_base_pointcloud_registration_tpu_torch.io.synthetic import (
        SyntheticWorld, constant_twist_platform, simulate_scan)
    from feature_base_pointcloud_registration_tpu_torch.ops import (
        features as tfeatures, fetch as tfetch)
    from feature_base_pointcloud_registration_tpu_torch.ops.features import (
        window_labels)
    from feature_base_pointcloud_registration_tpu_torch.ops.gn_round import (
        gn_round)
    from feature_base_pointcloud_registration_tpu_torch.ops.projection import (
        project_scan)
    from feature_base_pointcloud_registration_tpu_torch.ops import (
        hashgrid as th, register as treg)
    from feature_base_pointcloud_registration_tpu_torch.ops.register import (
        grid_register_step, register_rounds_core, world_components)
    from feature_base_pointcloud_registration_tpu_torch.parallel.batch import (
        build_map_planar_tables)
    from feature_base_pointcloud_registration_tpu_torch.pipeline.cloud_info import (  # noqa: E501
        DeskewInfo)
    from feature_base_pointcloud_registration_tpu_torch.pipeline.frontend import (  # noqa: E501
        make_deskew_info, process_scan)
    from feature_base_pointcloud_registration_tpu_torch.pipeline.localization import (  # noqa: E501
        GlobalMap, LocalizationPipeline, _crop_local_map)
    from feature_base_pointcloud_registration_tpu_torch.pipeline.scan_buffer import (  # noqa: E501
        OdomQueue, ScanBuffer)
    import oracle

    cpu = torch.device("cpu")
    params = Params()
    world = SyntheticWorld()

    # ---- the map, written with the port's write_pcd and loaded as the
    # reference starts up (GlobalMap caps 1<<19 / 1<<20, downsampled) ----
    map_dir = os.path.join(REPO, "build", "localization_map")
    os.makedirs(map_dir, exist_ok=True)
    for name, pts in (("cloudCorner.pcd", world.corner_map_points()),
                      ("cloudSurf.pcd", world.surf_map_points())):
        write_pcd(os.path.join(map_dir, name), dict(
            x=pts[:, 0], y=pts[:, 1], z=pts[:, 2],
            intensity=np.zeros(len(pts), np.float32)))
    t0 = time.perf_counter()
    gm = GlobalMap.from_pcd_dir(params, map_dir, device=dev)
    torch.cuda.synchronize()
    print(f"phase 7 map: corner {int(gm.corner_mask.sum())} surf "
          f"{int(gm.surf_mask.sum())} points after downsampling, loaded in "
          f"{(time.perf_counter() - t0) * 1e3:.1f} ms", flush=True)

    # ---- the platform: ground truth, raw IMU (sensor frame), odometry ----
    n_scans = N_LOC + 2                  # the ScanBuffer holds two back
    imu, states = constant_twist_platform(
        n_scans * LOC_SPACING + 0.3, ext_rot=params.ext_rot,
        ext_rpy=params.ext_rpy, gravity=params.imu_gravity)
    w_body, v_body = np.array([0.0, 0.0, 0.15]), np.array([1.2, 0.0, 0.0])
    imu_t = np.array([s[0] for s in imu])
    _, gyr_l, quat_l, ok = imu_converter(params, *(
        torch.tensor(np.stack([s[i] for s in imu]), dtype=torch.float32)
        for i in (1, 2, 3)))
    if not bool(ok.all()):
        raise AssertionError("phase 7: imu_converter flagged a sample")
    rpy_l = torch.stack(euler_from_quat(quat_l), -1).numpy()
    gyr_l = gyr_l.numpy()
    gt6 = np.concatenate([
        torch.stack(rot_to_euler(torch.from_numpy(
            np.stack([R for _, R, _ in states]))), -1).numpy(),
        np.stack([p for _, _, p in states])], 1).astype(np.float32)
    odom = OdomQueue()
    for (t, _, _), pose in zip(states, gt6):
        odom.push(t, pose)

    def scan_at(t, seed):
        """A motion-skewed scan starting at t, and its ground truth."""
        i = int(round(t * 100))
        return simulate_scan(world, gt6[i], seed=seed, spin_rpy_rate=w_body,
                             vel_world=states[i][1] @ v_body), gt6[i]

    scans = [scan_at(k * LOC_SPACING, seed=k) for k in range(n_scans)]

    # ---- the main path, counted: ScanBuffer -> imu table -> step; the
    # picking's host syncs counted by the CUDA sync debug mode ----
    counted = {"block_fetch": tfetch.block_fetch,
               "resident_fetch": tfetch.resident_fetch, "gn_round": gn_round,
               "ring_pick": tfeatures.ring_pick,
               "rounds_gn": rounds_gn_wrapper()}
    real_fetch_rows = tfetch.fetch_rows
    calls, check = [], {"on": True}
    checked_fetch_rows = fetch_recorder(real_fetch_rows, calls, check)

    pipe = LocalizationPipeline(params, gm)
    pipe.pose = scans[0][1].copy()       # a map-frame initial guess
    buf = ScanBuffer()
    inputs, ests, per_step, wall, iters, pick_syncs = [], [], [], [], [], []
    solve_syncs = []
    real_pick = tfeatures._pick
    real_solve = treg.register_rounds_core
    tfetch.fetch_rows = checked_fetch_rows
    tfeatures._pick = sync_counter(real_pick, pick_syncs)
    treg.register_rounds_core = sync_counter(real_solve, solve_syncs)
    unrecord = record_rounds("phase 7")
    try:
        torch.cuda.synchronize()
        for w in counted.values():
            w.launches = 0
        for k, (s, _) in enumerate(scans):
            out = buf.push(raw_of(s, dev), k * LOC_SPACING)
            if out is None:
                continue
            j = len(inputs)
            t_cur = out.time_scan_cur
            t_end = t_cur + float(scans[j][0]["time"].max())  # timeScanEnd
            avail, guess, rid, incre, flag = odom.deskew_info(t_cur, t_end)
            last = np.nonzero(imu_t <= t_cur + 0.01)[0][-1]
            dsk_cpu = make_deskew_info(
                params, imu_t, gyr_l, t_cur, t_end, imu_rpy=rpy_l[last],
                initial_guess=guess if avail else None, odom_incre=incre,
                odom_deskew_flag=flag, reset_id=rid, device=cpu)
            dsk = DeskewInfo(*(a.to(dev) for a in dsk_cpu))
            inputs.append((t_cur, dsk_cpu))
            check["on"] = j < LOC_CHECKED
            before = {n: w.launches for n, w in counted.items()}
            n_calls = len(calls)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ests.append(pipe.step(out.scan, t_cur, dsk).copy())
            torch.cuda.synchronize()
            wall.append(time.perf_counter() - t0)
            iters.append(int(pipe.last_result.iterations[0]))
            got = {n: w.launches - before[n] for n, w in counted.items()}
            per_step.append(got)
            ks = {c["K"] for c in calls[n_calls:]}
            if (got["block_fetch"] + got["resident_fetch"] != 6
                    or got["gn_round"] or got["ring_pick"] != 1
                    or got["rounds_gn"] != 3 or ks != {LOC_K}):
                raise AssertionError(f"phase 7 step {j}: launches {got}, "
                                     f"K {ks}")
            if j == 5:
                # a scan 0.05 s later is under mappingProcessInterval
                s_x, _ = scan_at(t_cur + 0.05, seed=1000)
                before = {n: w.launches for n, w in counted.items()}
                est_x = pipe.step(raw_of(s_x, dev), t_cur + 0.05, dsk)
                moved = {n: w.launches - before[n]
                         for n, w in counted.items()}
                print(f"phase 7 interval gate: scan at +0.05 s kept the pose"
                      f" {np.array_equal(est_x, ests[-1])}, launches {moved},"
                      f" last processed {pipe.time_last_processing:.2f} s",
                      flush=True)
                if not (np.array_equal(est_x, ests[-1])
                        and not any(moved.values())
                        and pipe.time_last_processing == t_cur):
                    raise AssertionError("phase 7: the interval gate let a "
                                         "scan through")
        torch.cuda.synchronize()
        launches = {n: w.launches for n, w in counted.items()}
    finally:
        tfetch.fetch_rows = real_fetch_rows
        tfeatures._pick = real_pick
        treg.register_rounds_core = real_solve
        unrecord()
    print(f"phase 7 launches: {launches} over {len(inputs)} steps; per "
          f"step {per_step[0]}", flush=True)
    kinds = sorted({(c["kind"], c["W"], c["Q"]) for c in calls})
    print(f"phase 7 fetch calls (kind, W, Q): {kinds}", flush=True)
    if len(inputs) != N_LOC:
        raise AssertionError(f"phase 7: {len(inputs)} steps, want {N_LOC}")
    checked, fetch_err = checked_fetches(calls)
    print(f"phase 7 fetches of steps 0-{LOC_CHECKED - 1} against their plain"
          f" versions: {sum(c['equal'] for c in checked)}/{len(checked)} "
          f"bitwise equal, max_abs_err {fetch_err}", flush=True)
    if not (len(checked) == 6 * LOC_CHECKED
            and all(c["equal"] for c in checked)):
        raise AssertionError("phase 7: a fetch kernel != its plain version")

    # ---- (f) accuracy against the ground truth ----
    gt = np.stack([scans[j][1] for j in range(N_LOC)])
    est = np.stack(ests)
    err = np.linalg.norm(est[:, 3:] - gt[:, 3:], axis=1)
    ate = float(np.sqrt((err ** 2).mean()))
    print(f"phase 7 accuracy: max translation error after step 0 "
          f"{err[1:].max():.6f} m, ate_vs_gt_m {ate}; rotation error max "
          f"{np.abs(est[:, :3] - gt[:, :3]).max():.6f} rad; GN iterations "
          f"a step {iters}; n_corr of the last step "
          f"{int(pipe.last_result.n_corr[0])}", flush=True)
    if not (np.isfinite(est).all() and err[1:].max() < 0.06 and ate < 0.05):
        raise AssertionError(f"phase 7: errors {err}")

    # ---- (e) the same steps on the CPU (the plain fetch versions) ----
    gm_cpu = GlobalMap.from_pcd_dir(params, map_dir, device=cpu)
    pipe_cpu = LocalizationPipeline(params, gm_cpu)
    pipe_cpu.pose = scans[0][1].copy()
    d_cpu = max(float(np.abs(pipe_cpu.step(
        raw_of(scans[j][0], cpu), t, dsk) - ests[j]).max())
        for j, (t, dsk) in enumerate(inputs[:LOC_CHECKED]))
    print(f"phase 7 card vs CPU: steps 0-{LOC_CHECKED - 1} pose |diff| max "
          f"{d_cpu:.3e}", flush=True)
    if not d_cpu <= 1e-4:
        raise AssertionError(f"phase 7: card vs CPU poses differ by {d_cpu}")

    # ---- (a) strict picks of scans 0-2 against the serial oracle ----
    for j in range(LOC_CHECKED):
        cloud = project_scan(params, raw_of(scans[j][0], dev, batch=True))
        win, label, span, first = window_labels(params, cloud)
        num = int(cloud.num_points[0])
        c = {f: getattr(cloud, f)[0].cpu().numpy() for f in cloud._fields}
        ref = oracle.extract_features(dict(
            point_range=c["point_range"][:num],
            point_col_ind=c["point_col_ind"][:num],
            start_ring_index=c["start_ring_index"],
            end_ring_index=c["end_ring_index"], points=c["points"][:num]),
            params.edge_threshold, params.surf_threshold)
        label = label[0].cpu().numpy()
        pvalid = win["pvalid"][0].cpu().numpy()
        flat = first[0].cpu().numpy()[:, None] - 8 + np.arange(
            label.shape[1])
        pairs = [(set(flat[(label == 1) & pvalid].tolist()),
                  {i for idx in ref["corner_idx"] for i in idx}),
                 (set(flat[span[0].cpu().numpy() & (label <= 0)
                           & pvalid].tolist()),
                  {i for idx in ref["surf_idx"] for i in idx})]
        print(f"phase 7 strict picks scan {j}: corner {len(pairs[0][0])} "
              f"equal {pairs[0][0] == pairs[0][1]}, surf candidates "
              f"{len(pairs[1][0])} equal {pairs[1][0] == pairs[1][1]}",
              flush=True)
        if not all(a == b for a, b in pairs):
            raise AssertionError(f"phase 7: strict picks of scan {j} != "
                                 "the oracle's")

    # ---- (b) deskewed points of scan 0 against the oracle (rotation) ----
    dsk0 = inputs[0][1]
    n_imu = int(dsk0.imu_count[0]) + 1
    cloud = project_scan(params, raw_of(scans[0][0], dev, batch=True),
                         DeskewInfo(*(a.to(dev) for a in dsk0._replace(
                             odom_deskew_flag=torch.zeros(1, dtype=bool)))))
    s0 = scans[0][0]
    ref = oracle.project_scan(
        s0["xyz"], s0["ring"], s0["time"], s0["valid"],
        deskew=oracle.find_rotation_factory(
            dsk0.imu_time[0, :n_imu].numpy(),
            dsk0.imu_rot[0, :n_imu].numpy()))
    n = len(ref["point_range"])
    pts = cloud.points[0, :n].cpu().numpy()
    d_desk = float(np.abs(pts - ref["points"]).max())
    moved = float(np.abs(pts - project_scan(params, raw_of(
        s0, dev, batch=True)).points[0, :n].cpu().numpy()).max())
    print(f"phase 7 deskew scan 0: {n} points, |diff| vs oracle max "
          f"{d_desk:.3e} m (the deskew moved points by up to {moved:.4f} m)",
          flush=True)
    if not (int(cloud.num_points[0]) == n and d_desk <= 2e-5):
        raise AssertionError(f"phase 7: deskew vs oracle {d_desk}")

    # ---- timings: the step split with CUDA events, tables, fetches ----
    he, rhe = params.local_map_half_extent, params.register_grid_half_extent
    n_split = 5
    split = step_split(params, gm, [(scans[j][0], inputs[j][1], ests[j - 1])
                                    for j in range(3, 3 + n_split)])
    print(f"time phase 7 step: {np.mean(wall[1:]) * 1e3:.2f} ms wall "
          f"(steps 1-{N_LOC - 1}; min {np.min(wall) * 1e3:.2f}, max "
          f"{np.max(wall) * 1e3:.2f}); split over {n_split} steps (CUDA "
          f"events): frontend (strict + deskew) {split[0]:.2f} ms, crop "
          f"{split[1]:.2f} ms, tables {split[2]:.2f} ms, solve {split[3]:.2f}"
          f" ms", flush=True)
    print(f"phase 7 host syncs in picking per step (CUDA sync debug mode):"
          f" mean {np.mean(pick_syncs):.1f} min {min(pick_syncs)} max "
          f"{max(pick_syncs)} over {len(pick_syncs)} steps", flush=True)
    if not (len(pick_syncs) == N_LOC and max(pick_syncs) == 0):
        raise AssertionError(f"phase 7: host syncs in picking {pick_syncs}")
    # steps 0-2 compare their fetches with the plain versions inside the
    # solve, which syncs: the solve's own syncs are those of the others
    print(f"phase 7 host syncs in the solve (register_rounds_core) per step "
          f"(CUDA sync debug mode), steps {LOC_CHECKED}-{N_LOC - 1}: "
          f"{solve_syncs[LOC_CHECKED:]}; steps 0-{LOC_CHECKED - 1} (fetches "
          f"checked): {solve_syncs[:LOC_CHECKED]}", flush=True)
    if not (len(solve_syncs) == N_LOC
            and max(solve_syncs[LOC_CHECKED:]) == 0):
        raise AssertionError(f"phase 7: host syncs in the solve "
                             f"{solve_syncs}")
    # the frontend's split and the step's wall time with the picking on the
    # kernel and on its plain version (the parent's route), in turns
    print_frontend_split("phase 7", frontend_split(
        params, [(scans[j][0], inputs[j][1])
                 for j in range(3, 3 + n_split)], dev))
    saved = (pipe.pose.copy(), pipe.time_last_processing)
    step_ab, step_diff = {"kernel": [], "plain": []}, 0.0
    for route in ("kernel", "plain", "plain", "kernel"):
        with picking_route(route):
            for j in range(3, 3 + n_split):
                t, dsk_cpu = inputs[j]
                pipe.pose, pipe.time_last_processing = ests[j - 1].copy(), -1.0
                raw_j = raw_of(scans[j][0], dev)
                dsk = DeskewInfo(*(a.to(dev) for a in dsk_cpu))
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                est_j = pipe.step(raw_j, t, dsk)
                torch.cuda.synchronize()
                step_ab[route].append((time.perf_counter() - t0) * 1e3)
                step_diff = max(step_diff,
                                float(np.abs(est_j - ests[j]).max()))
    pipe.pose, pipe.time_last_processing = saved
    print(f"time phase 7 step wall, steps 3-{2 + n_split} twice each in "
          f"turns: picking on the kernel {np.mean(step_ab['kernel']):.2f} ms,"
          f" on its plain version (the parent's route) "
          f"{np.mean(step_ab['plain']):.2f} ms; poses vs the main run |diff|"
          f" max {step_diff:.3e}", flush=True)
    # the step's wall time and split and its solve's host syncs with the
    # rounds solver's iterations on the kernel and on the parent's loop
    # (rounds_gn_reference), in turns
    runs = [(scans[j][0], inputs[j][1], ests[j - 1])
            for j in range(3, 3 + n_split)]
    solve_ab = {r: {"wall": [], "split": [], "syncs": [], "diff": 0.0}
                for r in ("kernel", "plain")}
    for route in ("kernel", "plain", "plain", "kernel"):
        ab = solve_ab[route]
        with rounds_route(route):
            ab["split"].append(step_split(params, gm, runs))
            treg.register_rounds_core = sync_counter(real_solve, ab["syncs"])
            try:
                for j in range(3, 3 + n_split):
                    t, dsk_cpu = inputs[j]
                    pipe.pose = ests[j - 1].copy()
                    pipe.time_last_processing = -1.0
                    raw_j = raw_of(scans[j][0], dev)
                    dsk = DeskewInfo(*(a.to(dev) for a in dsk_cpu))
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    est_j = pipe.step(raw_j, t, dsk)
                    torch.cuda.synchronize()
                    ab["wall"].append((time.perf_counter() - t0) * 1e3)
                    ab["diff"] = max(ab["diff"],
                                     float(np.abs(est_j - ests[j]).max()))
            finally:
                treg.register_rounds_core = real_solve
    pipe.pose, pipe.time_last_processing = saved
    for route, name in (("kernel", "the rounds_gn kernel"),
                        ("plain", "the parent's loop (rounds_gn_reference)")):
        ab = solve_ab[route]
        sp = np.mean(ab["split"], axis=0)
        print(f"time phase 7 step, steps 3-{2 + n_split} twice each in turns,"
              f" the solve's iterations on {name}: wall "
              f"{np.mean(ab['wall']):.2f} ms (min {np.min(ab['wall']):.2f}, "
              f"max {np.max(ab['wall']):.2f}); split (CUDA events) frontend "
              f"{sp[0]:.2f} ms, crop {sp[1]:.2f} ms, tables {sp[2]:.2f} ms, "
              f"solve {sp[3]:.2f} ms; host syncs in the solve a step mean "
              f"{np.mean(ab['syncs']):.1f} min {min(ab['syncs'])} max "
              f"{max(ab['syncs'])}; poses vs the main run |diff| max "
              f"{ab['diff']:.3e}", flush=True)
    if max(solve_ab["kernel"]["syncs"]) != 0:
        raise AssertionError("phase 7: host syncs in the kernel's solve")
    # the step with the rounds kernel at the rule's cluster size and at one
    # CTA a lane, in turns: wall, split, and the last step profiled on each
    clus = {r: {"wall": [], "split": [], "busy": [], "diff": 0.0}
            for r in ("chosen", "C=1")}
    for route in ("chosen", "C=1", "C=1", "chosen"):
        ab = clus[route]
        with rounds_cluster(None if route == "chosen" else 1):
            ab["split"].append(step_split(params, gm, runs))
            for j in range(3, 3 + n_split):
                t, dsk_cpu = inputs[j]
                pipe.pose = ests[j - 1].copy()
                pipe.time_last_processing = -1.0
                raw_j = raw_of(scans[j][0], dev)
                dsk = DeskewInfo(*(a.to(dev) for a in dsk_cpu))
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                est_j = pipe.step(raw_j, t, dsk)
                torch.cuda.synchronize()
                ab["wall"].append((time.perf_counter() - t0) * 1e3)
                ab["diff"] = max(ab["diff"],
                                 float(np.abs(est_j - ests[j]).max()))
            t, dsk_cpu = inputs[-1]
            pipe.pose = ests[-2].copy()
            pipe.time_last_processing = -1.0
            ab["busy"].append(profile_call(lambda: pipe.step(
                raw_of(scans[N_LOC - 1][0], dev), t,
                DeskewInfo(*(a.to(dev) for a in dsk_cpu))))[:2])
    pipe.pose, pipe.time_last_processing = saved
    for route, name in (("chosen", "the rule's cluster size "
                                   f"({rounds_cluster_of(*ROUNDS_INPUTS['phase 7'][0])})"),
                        ("C=1", "one CTA a lane (cluster 1)")):
        ab = clus[route]
        sp = np.mean(ab["split"], axis=0)
        w_p = float(np.mean([w for w, _ in ab["busy"]]))
        b_p = float(np.mean([b for _, b in ab["busy"]]))
        ROUNDS_TURNS.setdefault("phase 7", {})[route] = dict(
            wall_ms=float(np.mean(ab["wall"])), solve_ms=float(sp[3]),
            tables_ms=float(sp[2]), busy_share=b_p / w_p)
        print(f"time phase 7 step, steps 3-{2 + n_split} twice each in turns,"
              f" the rounds kernel at {name}: wall "
              f"{np.mean(ab['wall']):.2f} ms (median "
              f"{np.median(ab['wall']):.2f}, min {np.min(ab['wall']):.2f}, "
              f"max {np.max(ab['wall']):.2f}; {ab['wall']}); split (CUDA "
              f"events) frontend {sp[0]:.2f} ms, crop {sp[1]:.2f} ms, tables "
              f"{sp[2]:.2f} ms, solve {sp[3]:.2f} ms; step {N_LOC - 1} "
              f"profiled twice: wall {w_p:.2f} ms, device busy {b_p:.2f} ms "
              f"({b_p / w_p:.1%}); poses vs the main run |diff| max "
              f"{ab['diff']:.3e}", flush=True)
    # one more step, profiled: how much of it the device is busy
    t, dsk_cpu = inputs[-1]
    pipe.time_last_processing = -1.0
    wall_p, busy, top = profile_call(lambda: pipe.step(
        raw_of(scans[N_LOC - 1][0], dev), t,
        DeskewInfo(*(a.to(dev) for a in dsk_cpu))))
    print(f"profile phase 7 step (torch.profiler): wall {wall_p:.2f} ms, "
          f"device busy {busy:.2f} ms ({busy / wall_p:.1%}), {len(top)} "
          f"kernel names; by device time: " + "; ".join(
              f"{name[:60]} {ms:.3f}" for name, ms in top[:8]), flush=True)

    # the tables of step 0's local map, and the fetch at its queries
    guess = torch.from_numpy(scans[0][1][None]).to(dev)
    lmap, _ = _crop_local_map(gm.corner_xyz, gm.corner_mask, gm.surf_xyz,
                              gm.surf_mask, guess[0, 3:6], half_extent=he,
                              map_corner_cap=params.map_corner_cap,
                              map_surf_cap=params.map_surf_cap)
    ctab, stab, origin, dims = build_map_planar_tables(
        lmap, guess[0, 3:6], rhe, resident=True, lower_pad=True)
    batched = build_map_planar_tables(lmap, guess[0, 3:6], rhe,
                                      resident=True)[:2]
    n_rows = (dims[0] + 1) * (dims[1] + 1) * (dims[2] + 1)
    _, feats = process_scan(params, raw_of(scans[0][0], dev, batch=True),
                            DeskewInfo(*(a.to(dev) for a in inputs[0][1])))
    fetch_t = {}
    n_cells = dims[0] * dims[1] * dims[2]
    for name, tab, old, cap, xyz in (
            ("corner", ctab, batched[0], 16, feats.corner_xyz),
            ("surf", stab, batched[1], 64, feats.surf_xyz)):
        kind, rows, W, nbytes = table_info(tab)
        print(f"phase 7 table {name}: {kind}, {rows} rows of W {W} "
              f"({nbytes} B; the raw planar table {(n_rows + 1) * 12 * W} "
              f"B, the sentinel table {(n_cells + 1) * 12 * cap} B; dims "
              f"{dims}, {n_rows} block rows with the lower pad); fits the "
              f"{tfetch.RESIDENT_TABLE_CAP} B resident cap "
              f"{kind == 'resident'}; on the batched solvers' row space "
              f"(no lower pad): {table_info(old)[0]}, {table_info(old)[1]} "
              f"rows, {table_info(old)[3]} B, raw "
              f"{(n_cells + 1) * 12 * W} B", flush=True)
        qx, qy, qz = (c.reshape(-1).contiguous()
                      for c in world_components(guess, xyz))
        bcell = tfetch.block_cell_of_xyz(qx, qy, qz, origin, 2.0, dims=dims,
                                         lower_pad=True)
        if kind == "resident":
            fn, plain = tfetch.resident_fetch, tfetch.resident_fetch_reference
            table, bc = tab.table, tab.rows_index[bcell.long()]
        else:
            fn, plain, table, bc = (tfetch.block_fetch,
                                    tfetch.block_fetch_reference, tab, bcell)
        ms = cuda_ms(lambda: fn(table, bc, qx, qy, qz, K=LOC_K), 20)
        plain_ms = cuda_ms(lambda: plain(table, bc, qx, qy, qz, K=LOC_K), 2)
        b_ms, b_by = fetch_bound(table, bc, LOC_K)
        fetch_t[name] = (fn.__name__, ms, plain_ms, b_ms, b_by)
        print(f"time phase 7 fetch {name} ({fn.__name__}, Q {bc.shape[0]}, "
              f"W {W}, K {LOC_K}, {-(-bc.shape[0] // kernels.FETCH_TILE)} "
              f"tiles): kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, bound "
              f"{b_ms:.4f} ms ({b_by}); {fetch_smem(W, LOC_K)} B of shared "
              f"memory a block", flush=True)
    # registers and spills of the K=16 fetch instances these widths and
    # W=512 run (the row width picks the instance: slots a lane holds)
    used = {f"fetch_tile_kernel<{LOC_K},{-(-min(w, 512) // 128) * 4}>"
            for w in {c["W"] for c in calls} | {512}}
    for log in sorted(glob.glob(os.path.join(kernels.BUILD_DIR,
                                             "libfbpr_*fetch*.log"))):
        print_ptxas("phase 7 " + os.path.basename(log).split("-")[0][
            len("libfbpr_"):], log, only=used)
    print(f"phase 7 fetch shared memory at W 512, K {LOC_K}: "
          f"{fetch_smem(512, LOC_K)} B a block", flush=True)
    # step 0 on the batched solvers' row space: no query of it lies within
    # half a cell of a lower face, so the solve must be the step's, bitwise
    q0 = torch.cat([torch.stack(world_components(guess, x), -1)[0][m[0]]
                    for x, m in ((feats.corner_xyz, feats.corner_mask),
                                 (feats.surf_xyz, feats.surf_mask))])
    near = int((th._octant_base(q0, origin, 2.0) == -1).any(1).sum())
    step = grid_register_step(lmap, feats, guess, half_extent=rhe)
    old = register_rounds_core(feats, *[
        tfetch.make_pallas_block_knn(t, origin, 2.0, dims=dims, cell_cap=0,
                                     k=LOC_K) for t in batched], guess)
    same = (torch.equal(step.pose6, old.pose6)
            and torch.equal(step.n_corr, old.n_corr))
    print(f"phase 7 step 0 on the batched row space: {near} of "
          f"{q0.shape[0]} queries within half a cell of a lower face; pose "
          f"and n_corr bitwise the step's {same}", flush=True)
    if not (near == 0 and same):
        raise AssertionError("phase 7: the lower pad moved a step")
    steps = [(scans[j][0], scans[j][1], *inputs[j], ests[j])
             for j in range(N_DENSE)]
    return launches, fetch_t, fetch_err, steps


def lower_face_phase(dev):
    """Phase 7 (g): `grid_register_step` on a grid whose lower x face lies
    0.5 m behind the room's x = -25 m wall (tests/test_torch_register_fast
    .py's scene: the seed-9 scan at LF_POSE_GT from LF_GUESS, the grid
    +-LF_HALF around the guess), the world's feature map at default
    Params, strict picking.  The step counted (6 K=16 fetches, 0 GN
    rounds), its fetches bitwise their plain versions, its pose within
    1e-4 of the same step on the CPU; at round 0's queries, the near-face
    ones (octant base -1 on an axis) counted, and the candidates the
    kernels (`resident_fetch` on the step's compact tables, `block_fetch`
    on their raw form) and their plain versions keep for them, bitwise
    equal and equal to the octant rule's (`grid_knn_oct_sentinel`: d2
    bitwise, real picks' coordinates bitwise), beside what the batched
    solvers' row space keeps (none).  Returns (launches {wrapper: count}
    of the step, {kernel: max_abs_err} of every checked fetch)."""
    import torch

    from feature_base_pointcloud_registration_tpu_torch.config import Params
    from feature_base_pointcloud_registration_tpu_torch.io.synthetic import (
        SyntheticWorld, build_feature_map, simulate_scan)
    from feature_base_pointcloud_registration_tpu_torch.ops import (
        fetch as tfetch, hashgrid as th)
    from feature_base_pointcloud_registration_tpu_torch.ops.gn_round import (
        gn_round)
    from feature_base_pointcloud_registration_tpu_torch.ops.register import (
        grid_register_step, world_components)
    from feature_base_pointcloud_registration_tpu_torch.parallel.batch import (
        build_map_grids, build_map_planar_tables)
    from feature_base_pointcloud_registration_tpu_torch.pipeline.cloud_info import (  # noqa: E501
        FeatureMap, RawScan, ScanFeatures)
    from feature_base_pointcloud_registration_tpu_torch.pipeline.frontend import (  # noqa: E501
        process_scan)

    cpu = torch.device("cpu")
    params = Params()
    world = SyntheticWorld()
    s = simulate_scan(world, LF_POSE_GT, seed=9)
    raw = RawScan.from_numpy(s["xyz"], s["intensity"], s["ring"], s["time"],
                             device=dev)._replace(
        valid=torch.from_numpy(s["valid"]).to(dev))
    _, feats = process_scan(params, RawScan(*(a[None] for a in raw)))
    lmap = FeatureMap(*(torch.from_numpy(a).to(dev) for a in build_feature_map(
        world, params.map_corner_cap, params.map_surf_cap)))
    guess = torch.from_numpy(LF_GUESS[None]).to(dev)

    # ---- the step, counted; its fetches against their plain versions ----
    counted = {"block_fetch": tfetch.block_fetch,
               "resident_fetch": tfetch.resident_fetch, "gn_round": gn_round,
               "ring_pick": ring_pick_wrapper(),
               "rounds_gn": rounds_gn_wrapper()}
    real_fetch_rows = tfetch.fetch_rows
    calls = []
    tfetch.fetch_rows = fetch_recorder(real_fetch_rows, calls, {"on": True})
    try:
        for w in counted.values():
            w.launches = 0
        res = grid_register_step(lmap, feats, guess, half_extent=LF_HALF)
        launches = {n: w.launches for n, w in counted.items()}
    finally:
        tfetch.fetch_rows = real_fetch_rows
    checked, fetch_err = checked_fetches(calls)
    print(f"phase 7 (g) lower face: grid_register_step at half extent "
          f"{LF_HALF}, launches {launches}, fetches (kind, W, rows) "
          f"{sorted({(c['kind'], c['W'], c['rows']) for c in calls})}; "
          f"{sum(c['equal'] for c in checked)}/{len(checked)} bitwise equal"
          f" to their plain versions, max_abs_err {fetch_err}", flush=True)
    if not (launches["block_fetch"] + launches["resident_fetch"] == 6
            and launches["gn_round"] == 0 and launches["rounds_gn"] == 3
            and len(checked) == 6
            and all(c["equal"] for c in checked)):
        raise AssertionError("phase 7 (g): the step's fetches")

    # ---- round 0's queries: the near-face ones and what each path keeps --
    center = guess[0, 3:6]
    origin = th.grid_origin(center, LF_HALF, device=dev)
    dims = th.default_grid_spec(LF_HALF, 2.0)
    sent = build_map_grids(lmap, center, LF_HALF)[:2]
    step = {"resident": build_map_planar_tables(
                lmap, center, LF_HALF, resident=True, lower_pad=True)[:2],
            "raw": build_map_planar_tables(lmap, center, LF_HALF,
                                           lower_pad=True)[:2]}
    batched = build_map_planar_tables(lmap, center, LF_HALF,
                                      resident=True)[:2]
    near_total = 0
    for i, (name, cap, xyz, mask) in enumerate((
            ("corner", 16, feats.corner_xyz, feats.corner_mask),
            ("surf", 64, feats.surf_xyz, feats.surf_mask))):
        q = torch.stack(world_components(guess, xyz), -1)[0][mask[0]]
        qx, qy, qz = (q[:, j].contiguous() for j in range(3))
        near = (th._octant_base(q, origin, 2.0) == -1).any(1)
        near_total += int(near.sum())
        want_d2, want_nn = th.grid_knn_oct_sentinel(
            q, sent[i], origin, 2.0, dims=dims, cell_cap=cap, k=LOC_K)
        real = want_d2 < 1e30
        rows = tfetch.block_cell_of_xyz(qx, qy, qz, origin, 2.0, dims=dims,
                                        lower_pad=True)
        kept = {}
        for kind, tabs in step.items():
            tab = tabs[i]
            is_res = isinstance(tab, tfetch.PlanarTable)
            if is_res != (kind == "resident"):
                raise AssertionError(f"phase 7 (g): the {name} table is not "
                                     f"{kind}")
            d2, nn = tfetch.fetch_rows(tab, rows, qx, qy, qz, K=LOC_K,
                                       planes_out=False)
            table, bc = ((tab.table, tab.rows_index[rows.long()]) if is_res
                         else (tab, rows))
            d2r, cr = tfetch.block_fetch_reference(table, bc, qx, qy, qz,
                                                   K=LOC_K)
            nnr = cr.view(3, LOC_K, -1).permute(2, 1, 0)
            equal = torch.equal(d2, d2r) and torch.equal(nn, nnr)
            octant = (torch.equal(d2, want_d2)
                      and torch.equal(nn[real], want_nn[real]))
            kept[kind] = (int((d2[near] < 1e30).sum()),
                          int((d2r[near] < 1e30).sum()))
            err = max((d2 - d2r).abs().max().item(),
                      (nn - nnr).abs().max().item())
            kname = "resident_fetch" if is_res else "block_fetch"
            fetch_err[kname] = max(fetch_err.get(kname, 0.0), err)
            print(f"phase 7 (g) {name} {kind} table ({kname}, "
                  f"{table_info(tab)[1]} rows of W {table_info(tab)[2]}): "
                  f"{q.shape[0]} queries, {int(near.sum())} within half a "
                  f"cell of a lower face; candidates kept for them: kernel "
                  f"{kept[kind][0]}, plain {kept[kind][1]}, octant rule "
                  f"{int(real[near].sum())}; kernel == plain {equal}, == "
                  f"octant rule {octant}", flush=True)
            if not (equal and octant and kept[kind][0] == kept[kind][1]
                    == int(real[near].sum())):
                raise AssertionError(f"phase 7 (g): {name} {kind} fetch at "
                                     "the lower face")
        bd2, _ = tfetch.fetch_rows(
            batched[i], tfetch.block_cell_of_xyz(qx, qy, qz, origin, 2.0,
                                                 dims=dims),
            qx, qy, qz, K=LOC_K, planes_out=False)
        print(f"phase 7 (g) {name}: the batched solvers' row space keeps "
              f"{int((bd2[near] < 1e30).sum())} candidates for the "
              f"near-face queries", flush=True)
    if near_total < 50:
        raise AssertionError(f"phase 7 (g): {near_total} near-face queries")

    # ---- the same step on the CPU ----
    res_cpu = grid_register_step(
        FeatureMap(*(a.to(cpu) for a in lmap)),
        ScanFeatures(*(a.to(cpu) for a in feats)), guess.to(cpu),
        half_extent=LF_HALF)
    pose, pose_cpu = res.pose6[0].cpu().numpy(), res_cpu.pose6[0].numpy()
    d = float(np.abs(pose - pose_cpu).max())
    print(f"phase 7 (g) card vs CPU: pose |diff| {d:.3e}, n_corr "
          f"{int(res.n_corr[0])} / {int(res_cpu.n_corr[0])}, iterations "
          f"{int(res.iterations[0])} / {int(res_cpu.iterations[0])}; "
          f"translation error {np.linalg.norm(pose[3:] - LF_POSE_GT[3:]):.4f}"
          f" m ({near_total} near-face queries at the guess)", flush=True)
    if not (d <= 1e-4 and bool(res.valid[0])):
        raise AssertionError(f"phase 7 (g): card vs CPU {d}")
    return launches, fetch_err


def collinear_fits(q, knn):
    """(the queries q [Q, 3] whose 5-NN from the fetch closure `knn` are
    collinear: the scatter's middle spread under 1 mm, of them those the
    surf plane fit's gates accept)."""
    import torch

    from feature_base_pointcloud_registration_tpu_torch.ops import (
        correspondence as corr)
    d2, nn = knn(q)
    valid = d2 < 1e37
    _, _, fit = corr.surf_correspondence_cand(
        q, torch.ones(q.shape[0], dtype=torch.bool, device=q.device), nn,
        valid)
    sel, _ = corr.select_smallest(corr._cand_d2(q, nn, valid), 5)
    w = sel.to(nn.dtype)[..., None]
    d = (nn - (nn * w).sum(1, keepdim=True) / 5) * w
    mid = torch.linalg.eigvalsh((d.transpose(1, 2) @ d).double() / 5)[:, 1]
    col = mid.clamp(min=0).sqrt() < 1e-3
    return int(col.sum()), int((col & fit).sum())


def dense_map_phase(dev, steps):
    """Phase 7 (h): phase 7's first N_DENSE steps (`steps`: scan, ground
    truth, time, deskew table, phase 7's pose) through
    `LocalizationPipeline.step` on an undownsampled map: the room's surf
    points at DENSE_SURF_SPACING, written with write_pcd and loaded with
    `GlobalMap.from_pcd_dir(downsample=False)`, at Params(map_surf_cap=
    DENSE_SURF_CAP), all else default.  The crop keeps every surf point,
    whose compact table passes the resident cap, so the step's surf table
    stays raw and `block_fetch` runs at K=16, W=DENSE_W on the path.
    Counted: 3 `block_fetch` (the raw surf table) and 3 `resident_fetch`
    (the compact corner table) a step, 0 GN rounds; the fetches of steps
    0-2 bitwise their plain versions; steps 0-2 within DENSE_CPU_TOL of
    the same steps on the CPU, and within 1e-4 with collinear 5-NN plane
    fits rejected (surf_min_planar_spread=DENSE_SPREAD); max translation
    error after step 0 < 0.06 m, ATE < 0.05 m.  Returns (launches
    {wrapper: count} over the steps, {kernel: max_abs_err} of the checked
    fetches, the K=16 W=DENSE_W block_fetch at step 0's surf queries {ms,
    plain_ms, bound_ms, bound_by, ...})."""
    import torch

    from feature_base_pointcloud_registration_tpu_torch import kernels
    from feature_base_pointcloud_registration_tpu_torch.config import Params
    from feature_base_pointcloud_registration_tpu_torch.io.pcd import (
        write_pcd)
    from feature_base_pointcloud_registration_tpu_torch.io.synthetic import (
        SyntheticWorld)
    from feature_base_pointcloud_registration_tpu_torch.ops import (
        fetch as tfetch)
    from feature_base_pointcloud_registration_tpu_torch.ops.gn_round import (
        gn_round)
    from feature_base_pointcloud_registration_tpu_torch.ops.register import (
        world_components)
    from feature_base_pointcloud_registration_tpu_torch.parallel.batch import (
        build_map_planar_tables)
    from feature_base_pointcloud_registration_tpu_torch.pipeline.cloud_info import (  # noqa: E501
        DeskewInfo)
    from feature_base_pointcloud_registration_tpu_torch.pipeline.frontend import (  # noqa: E501
        process_scan)
    from feature_base_pointcloud_registration_tpu_torch.pipeline.localization import (  # noqa: E501
        GlobalMap, LocalizationPipeline, _crop_local_map)

    t_phase = time.perf_counter()
    cpu = torch.device("cpu")
    params = Params(map_surf_cap=DENSE_SURF_CAP)
    world = SyntheticWorld()
    map_dir = os.path.join(REPO, "build", "localization_map_dense")
    os.makedirs(map_dir, exist_ok=True)
    for name, pts in (("cloudCorner.pcd", world.corner_map_points()),
                      ("cloudSurf.pcd",
                       world.surf_map_points(DENSE_SURF_SPACING))):
        write_pcd(os.path.join(map_dir, name), dict(
            x=pts[:, 0], y=pts[:, 1], z=pts[:, 2],
            intensity=np.zeros(len(pts), np.float32)))
    t0 = time.perf_counter()
    gm = GlobalMap.from_pcd_dir(params, map_dir, device=dev,
                                downsample=False)
    torch.cuda.synchronize()
    print(f"phase 7 (h) map: corner {int(gm.corner_mask.sum())} surf "
          f"{int(gm.surf_mask.sum())} points as written (downsample=False), "
          f"loaded in {(time.perf_counter() - t0) * 1e3:.1f} ms; Params("
          f"map_surf_cap={DENSE_SURF_CAP})", flush=True)

    def deskew(dsk_cpu, device):
        return DeskewInfo(*(a.to(device) for a in dsk_cpu))

    # ---- the main path, counted; the fetches of steps 0-2 checked ----
    counted = {"block_fetch": tfetch.block_fetch,
               "resident_fetch": tfetch.resident_fetch, "gn_round": gn_round,
               "ring_pick": ring_pick_wrapper(),
               "rounds_gn": rounds_gn_wrapper()}
    real_fetch_rows = tfetch.fetch_rows
    calls, check = [], {"on": True}
    pipe = LocalizationPipeline(params, gm)
    pipe.pose = steps[0][1].copy()
    ests, wall, its = [], [], []
    want = {"block_fetch": 3, "resident_fetch": 3, "gn_round": 0,
            "ring_pick": 1, "rounds_gn": 3}
    tfetch.fetch_rows = fetch_recorder(real_fetch_rows, calls, check)
    unrecord = record_rounds("phase 7 (h)")
    try:
        torch.cuda.synchronize()
        for w in counted.values():
            w.launches = 0
        for j, (s, _, t, dsk_cpu, _) in enumerate(steps):
            raw, dsk = raw_of(s, dev), deskew(dsk_cpu, dev)
            check["on"] = j < LOC_CHECKED
            before = {n: w.launches for n, w in counted.items()}
            n_calls = len(calls)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ests.append(pipe.step(raw, t, dsk).copy())
            torch.cuda.synchronize()
            wall.append(time.perf_counter() - t0)
            its.append((int(pipe.last_result.iterations[0]),
                        int(pipe.last_result.n_corr[0])))
            got = {n: w.launches - before[n] for n, w in counted.items()}
            step_calls = calls[n_calls:]
            raw_w = [c["W"] for c in step_calls if c["kind"] == "raw"]
            if (got != want or {c["K"] for c in step_calls} != {LOC_K}
                    or raw_w != [DENSE_W] * 3):
                raise AssertionError(f"phase 7 (h) step {j}: launches {got}, "
                                     f"raw table W {raw_w}")
        torch.cuda.synchronize()
        launches = {n: w.launches for n, w in counted.items()}
    finally:
        tfetch.fetch_rows = real_fetch_rows
        unrecord()
    tabs = sorted({(c["kind"], c["W"], c["rows"], c["bytes"])
                   for c in calls})
    print(f"phase 7 (h) launches: {launches} over {len(steps)} steps; fetch "
          f"tables (kind, W, rows, bytes): {tabs}", flush=True)
    checked, fetch_err = checked_fetches(calls)
    print(f"phase 7 (h) fetches of steps 0-{LOC_CHECKED - 1} against their "
          f"plain versions: {sum(c['equal'] for c in checked)}/"
          f"{len(checked)} bitwise equal, max_abs_err {fetch_err}",
          flush=True)
    if not (len(checked) == 6 * LOC_CHECKED
            and all(c["equal"] for c in checked)):
        raise AssertionError("phase 7 (h): a fetch kernel != its plain "
                             "version")

    # ---- accuracy against the ground truth; beside phase 7's poses ----
    gt = np.stack([st[1] for st in steps])
    est = np.stack(ests)
    err = np.linalg.norm(est[:, 3:] - gt[:, 3:], axis=1)
    ate = float(np.sqrt((err ** 2).mean()))
    d7 = np.abs(est - np.stack([st[4] for st in steps])).max(1)
    print(f"phase 7 (h) accuracy: max translation error after step 0 "
          f"{err[1:].max():.6f} m, ate_vs_gt_m {ate}; |pose - phase 7's "
          f"(downsampled map)| a step {[float(f'{d:.3e}') for d in d7]}",
          flush=True)
    if not (np.isfinite(est).all() and err[1:].max() < 0.06 and ate < 0.05):
        raise AssertionError(f"phase 7 (h): errors {err}")

    # ---- the same steps on the CPU (the plain fetch versions), at the
    # reference's settings and with collinear 5-NN fits rejected ----
    def run_steps(p, gmap, device):
        pl = LocalizationPipeline(p, gmap)
        pl.pose = steps[0][1].copy()
        out = []
        for s, _, t, dsk_cpu, _ in steps[:LOC_CHECKED]:
            out.append((pl.step(raw_of(s, device), t,
                                deskew(dsk_cpu, device)).copy(),
                        int(pl.last_result.iterations[0]),
                        int(pl.last_result.n_corr[0])))
        return out

    t0 = time.perf_counter()
    gm_cpu = GlobalMap.from_pcd_dir(params, map_dir, device=cpu,
                                    downsample=False)
    ref = run_steps(params, gm_cpu, cpu)
    t_cpu = time.perf_counter() - t0
    d_cpu = max(float(np.abs(r[0] - e).max()) for r, e in zip(ref, ests))
    print(f"phase 7 (h) card vs CPU: steps 0-{LOC_CHECKED - 1} pose |diff| "
          f"max {d_cpu:.3e}; (iterations, n_corr) card "
          f"{its[:LOC_CHECKED]}, CPU {[r[1:] for r in ref]} (the CPU's "
          f"steps took {t_cpu:.1f} s)", flush=True)
    spread = dataclasses.replace(params, surf_min_planar_spread=DENSE_SPREAD)
    card, ref = run_steps(spread, gm, dev), run_steps(spread, gm_cpu, cpu)
    d_spread = max(float(np.abs(a[0] - b[0]).max())
                   for a, b in zip(card, ref))
    print(f"phase 7 (h) card vs CPU with collinear 5-NN fits rejected "
          f"(surf_min_planar_spread {DENSE_SPREAD}): steps 0-"
          f"{LOC_CHECKED - 1} pose |diff| max {d_spread:.3e}; (iterations,"
          f" n_corr) card {[a[1:] for a in card]}, CPU "
          f"{[b[1:] for b in ref]}", flush=True)
    if not (d_cpu <= DENSE_CPU_TOL and d_spread <= 1e-4):
        raise AssertionError(f"phase 7 (h): card vs CPU poses differ by "
                             f"{d_cpu} ({d_spread} with collinear fits "
                             "rejected)")

    # ---- times: the step split with CUDA events, a profiled step ----
    he, rhe = params.local_map_half_extent, params.register_grid_half_extent
    split_steps = range(3, 6)
    split = step_split(params, gm, [(steps[j][0], steps[j][3], ests[j - 1])
                                    for j in split_steps])
    print(f"time phase 7 (h) step: {np.mean(wall[1:]) * 1e3:.2f} ms wall "
          f"(steps 1-{len(steps) - 1}; min {np.min(wall) * 1e3:.2f}, max "
          f"{np.max(wall) * 1e3:.2f}); split over {len(split_steps)} steps "
          f"(CUDA events): frontend (strict + deskew) {split[0]:.2f} ms, "
          f"crop {split[1]:.2f} ms, tables {split[2]:.2f} ms, solve "
          f"{split[3]:.2f} ms", flush=True)
    s, _, t, dsk_cpu, _ = steps[-1]
    raw, dsk = raw_of(s, dev), deskew(dsk_cpu, dev)
    pipe.time_last_processing = -1.0
    wall_p, busy, top = profile_call(lambda: pipe.step(raw, t, dsk))
    print(f"profile phase 7 (h) step (torch.profiler): wall {wall_p:.2f} ms,"
          f" device busy {busy:.2f} ms ({busy / wall_p:.1%}); by device "
          f"time: " + "; ".join(f"{name[:60]} {ms:.3f}"
                                for name, ms in top[:6]), flush=True)

    # ---- the K=16 W=DENSE_W fetch at step 0's surf queries ----
    guess = torch.from_numpy(steps[0][1][None]).to(dev)
    lmap, in_box = _crop_local_map(
        gm.corner_xyz, gm.corner_mask, gm.surf_xyz, gm.surf_mask,
        guess[0, 3:6], half_extent=he, map_corner_cap=params.map_corner_cap,
        map_surf_cap=params.map_surf_cap)
    ctab, stab, origin, dims = build_map_planar_tables(
        lmap, guess[0, 3:6], rhe, resident=True, lower_pad=True)
    if not (isinstance(ctab, tfetch.PlanarTable)
            and not isinstance(stab, tfetch.PlanarTable)
            and stab.shape[1] == 3 * DENSE_W):
        raise AssertionError("phase 7 (h): step 0's table kinds")
    compact = tfetch.compact_row_space(stab).table
    _, feats = process_scan(params, raw_of(steps[0][0], dev, batch=True),
                            deskew(steps[0][3], dev))
    qx, qy, qz = (c.reshape(-1).contiguous()
                  for c in world_components(guess, feats.surf_xyz))
    bcell = tfetch.block_cell_of_xyz(qx, qy, qz, origin, 2.0, dims=dims,
                                     lower_pad=True)
    ms = cuda_ms(lambda: tfetch.block_fetch(stab, bcell, qx, qy, qz,
                                            K=LOC_K), 20)
    plain_ms = cuda_ms(lambda: tfetch.block_fetch_reference(
        stab, bcell, qx, qy, qz, K=LOC_K), 2)
    b_ms, b_by = fetch_bound(stab, bcell, LOC_K)
    whole_ms = (stab.numel() * 4 + bcell.shape[0] * 16 * (1 + LOC_K)) / (
        HBM_BYTES_PER_S) * 1e3
    timing = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
              "bound_by": b_by, "K": LOC_K, "W": DENSE_W,
              "Q": bcell.shape[0], "rows": stab.shape[0] - 1,
              "table_bytes": stab.numel() * 4}
    print(f"phase 7 (h) step 0 tables: crop kept corner "
          f"{int(lmap.corner_mask.sum())} surf {int(lmap.surf_mask.sum())} "
          f"(in the box {in_box.tolist()}); surf raw {stab.shape[0] - 1} "
          f"rows of W {DENSE_W} ({stab.numel() * 4} B; compact it would "
          f"take {compact.numel() * 4} B in {compact.shape[0] - 1} rows, "
          f"over the {tfetch.RESIDENT_TABLE_CAP} B resident cap); corner "
          f"compact {table_info(ctab)[1]} rows of W {table_info(ctab)[2]} "
          f"({table_info(ctab)[3]} B)", flush=True)
    # the surf features whose 5-NN are collinear, at step 0's guess: the
    # plane fit's rank gate decides them on each device's rounding
    q = torch.stack([qx, qy, qz], -1)[feats.surf_mask[0]]
    lmap_cpu = type(lmap)(*(a.cpu() for a in lmap))
    col = {d.type: collinear_fits(q.to(d), tfetch.make_pallas_block_knn(
        t, o, 2.0, dims=dims, cell_cap=64, k=LOC_K))
        for d, t, o in ((dev, stab, origin), (cpu, *build_map_planar_tables(
            lmap_cpu, guess[0, 3:6].cpu(), rhe, resident=True,
            lower_pad=True)[1:3]))}
    print(f"phase 7 (h) step 0's {q.shape[0]} surf features: collinear "
          f"5-NN (middle spread < 1 mm) / of them accepted by the plane "
          f"fit's gates: card {col[dev.type]}, CPU {col['cpu']}",
          flush=True)
    print(f"time phase 7 (h) fetch surf (block_fetch, Q {bcell.shape[0]}, W "
          f"{DENSE_W}, K {LOC_K}, {-(-bcell.shape[0] // kernels.FETCH_TILE)}"
          f" tiles, {int((bcell != stab.shape[0] - 1).sum())} live, "
          f"{torch.unique(bcell[bcell != stab.shape[0] - 1]).numel()} "
          f"distinct rows): "
          f"kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, bound {b_ms:.4f} ms"
          f" ({b_by}; the whole table read once: {whole_ms:.4f} ms); "
          f"{fetch_smem(DENSE_W, LOC_K)} B of shared memory a block",
          flush=True)
    for log in sorted(glob.glob(os.path.join(kernels.BUILD_DIR,
                                             "libfbpr_block_fetch-*.log"))):
        print_ptxas("phase 7 (h) block_fetch", log, only={
            f"fetch_tile_kernel<{LOC_K},{-(-DENSE_W // 128) * 4}>"})
    print(f"phase 7 (h): {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches, fetch_err, timing


class StageTimer:
    """Host wall ms per named stage, the device synchronized at both ends
    of each timed call (`wrap` returns a timing wrapper of a function);
    calls nested in a timed call are counted in both stages."""

    def __init__(self, dev):
        self.dev = dev
        self.ms = {}
        self.calls = {}

    def sync(self):
        if self.dev.type == "cuda":
            import warnings

            import torch
            with warnings.catch_warnings():   # not one of the step's syncs
                warnings.simplefilter("ignore")
                torch.cuda.synchronize()

    def wrap(self, name, fn):
        def timed(*a, **kw):
            self.sync()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            self.sync()
            self.ms.setdefault(name, []).append(
                (time.perf_counter() - t0) * 1e3)
            self.calls.setdefault(name, []).append((a, kw, out))
            return out
        return timed


def slam_phase(dev):
    """Phase 8: the SLAM back end (SlamPipeline at its default capacities,
    loop closure on) on the card.  Returns (launches {wrapper: count} over
    the N_SLAM steps, {kernel: max_abs_err} of the checked fetches)."""
    import warnings

    import torch

    from feature_base_pointcloud_registration_tpu_torch import native
    from feature_base_pointcloud_registration_tpu_torch.config import Params
    from feature_base_pointcloud_registration_tpu_torch.geom.se3 import (
        euler_from_quat, rot_to_euler)
    from feature_base_pointcloud_registration_tpu_torch.imu.conversion import (
        imu_converter)
    from feature_base_pointcloud_registration_tpu_torch.io.synthetic import (
        SyntheticWorld, constant_twist_platform, pose6_to_matrix_np,
        simulate_scan)
    from feature_base_pointcloud_registration_tpu_torch.ops import (
        exact_gn as tex, fetch as tfetch, knn as tknn)
    from feature_base_pointcloud_registration_tpu_torch.ops.gn_round import (
        gn_round)
    from feature_base_pointcloud_registration_tpu_torch.ops.knn import (
        _extract_topk)
    from feature_base_pointcloud_registration_tpu_torch.ops.register import (
        register_scan_with_params)
    from feature_base_pointcloud_registration_tpu_torch.pipeline import (
        slam as tslam)
    from feature_base_pointcloud_registration_tpu_torch.pipeline.cloud_info import (  # noqa: E501
        DeskewInfo, RawScan)
    from feature_base_pointcloud_registration_tpu_torch.pipeline.frontend import (  # noqa: E501
        make_deskew_info)
    from feature_base_pointcloud_registration_tpu_torch.pipeline.localization import (  # noqa: E501
        GlobalMap, LocalizationPipeline)
    from feature_base_pointcloud_registration_tpu_torch.utils.log import (
        EventLog)

    cpu = torch.device("cpu")
    params = Params(loop_closure_enable_flag=True)
    world = SyntheticWorld()
    print(f"phase 8 native library available {native.available()}",
          flush=True)

    # ---- the platform: a circle of 3 m radius (0.45 m/s, 0.15 rad/s),
    # back at its start after 41.9 s; IMU in the sensor frame ----
    v_body = np.array([SLAM_SPEED, 0.0, 0.0])
    w_body = np.array([0.0, 0.0, SLAM_YAW_RATE])
    imu, states = constant_twist_platform(
        N_SLAM * SLAM_SPACING + 0.5, ext_rot=params.ext_rot,
        ext_rpy=params.ext_rpy, gravity=params.imu_gravity,
        w_body=w_body, v_body=v_body)
    imu_t = np.array([s_[0] for s_ in imu])
    _, gyr_l, quat_l, ok = imu_converter(params, *(
        torch.tensor(np.stack([s_[i] for s_ in imu]), dtype=torch.float32)
        for i in (1, 2, 3)))
    if not bool(ok.all()):
        raise AssertionError("phase 8: imu_converter flagged a sample")
    rpy_l = torch.stack(euler_from_quat(quat_l), -1).numpy()
    gyr_l = gyr_l.numpy()
    gt6 = np.concatenate([
        torch.stack(rot_to_euler(torch.from_numpy(
            np.stack([R for _, R, _ in states]))), -1).numpy(),
        np.stack([p_ for _, _, p_ in states])], 1).astype(np.float32)

    def scan_at(k):
        """Scan k (stamp k * SLAM_SPACING), skewed by the motion during its
        sweep, its deskew table (IMU only: the rotation guess and the
        rotation deskew; no odometry) and its ground truth."""
        t = k * SLAM_SPACING
        i = int(round(t * 100))
        s_ = simulate_scan(world, gt6[i], seed=500 + k, spin_rpy_rate=w_body,
                           vel_world=states[i][1] @ v_body)
        last = np.nonzero(imu_t <= t + 0.01)[0][-1]
        dsk = make_deskew_info(params, imu_t, gyr_l, t,
                               t + float(s_["time"].max()),
                               imu_rpy=rpy_l[last], device=cpu)
        return s_, dsk, gt6[i], t

    def raw_of(s_, device):
        return RawScan.from_numpy(
            s_["xyz"], s_["intensity"], s_["ring"], s_["time"],
            device=device)._replace(valid=torch.from_numpy(s_["valid"]).to(
                device))

    scans = [scan_at(k) for k in range(N_SLAM)]

    # ---- the main path, counted and timed ----
    counted = {"block_fetch": tfetch.block_fetch,
               "resident_fetch": tfetch.resident_fetch, "gn_round": gn_round,
               "ring_pick": ring_pick_wrapper(),
               "rounds_gn": rounds_gn_wrapper(), **pose_graph_counters(),
               **knn_icp_counters()}
    real = {name: getattr(tslam, name) for name in (
        "process_scan", "grid_register_step", "optimize_pose_graph",
        "icp_align")}
    real_fetch_rows = tfetch.fetch_rows
    calls, check = [], {"on": False}
    checked_fetch_rows = fetch_recorder(real_fetch_rows, calls, check)

    timer = StageTimer(dev)
    pipe = tslam.SlamPipeline(params, device=dev)
    log = EventLog()
    pipe._log = log
    stage_of = {"process_scan": "frontend",
                "grid_register_step": "tables + solve",
                "optimize_pose_graph": "graph LM", "icp_align": "ICP"}
    routes = []
    for name, stage in stage_of.items():
        setattr(tslam, name, timer.wrap(stage, lm_route_recorder(
            real[name], routes) if name == "optimize_pose_graph"
            else real[name]))
    methods = {"_surrounding_map": "local map", "_save_keyframe":
               "keyframe + graph", "maybe_close_loop": "loop closure",
               "_world_cloud": "loop submaps"}
    for name, stage in methods.items():
        setattr(pipe, name, timer.wrap(stage, getattr(pipe, name)))
    tfetch.fetch_rows = checked_fetch_rows
    ests, wall, per_step, syncs, n_kf = [], [], [], [], []
    try:
        timer.sync()
        for w in counted.values():
            w.launches = 0
        registered = 0
        for k, (s_, dsk, _, t) in enumerate(scans):
            raw = raw_of(s_, dev)
            dsk_d = DeskewInfo(*(a.to(dev) for a in dsk))
            check["on"] = registered < SLAM_CHECKED and k > 0
            before = {n: w.launches for n, w in counted.items()}
            n_calls = len(calls)
            timer.sync()
            t0 = time.perf_counter()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                if dev.type == "cuda":
                    torch.cuda.set_sync_debug_mode("warn")
                try:
                    ests.append(pipe.step(raw, t, dsk_d).copy())
                finally:
                    if dev.type == "cuda":
                        torch.cuda.set_sync_debug_mode("default")
            timer.sync()
            wall.append((time.perf_counter() - t0) * 1e3)
            syncs.append(sum("synchroniz" in str(w_.message)
                             for w_ in caught))
            n_kf.append(pipe.n_keyframes)
            got = {n: w.launches - before[n] for n, w in counted.items()}
            per_step.append(got)
            ks = {c["K"] for c in calls[n_calls:]}
            want = 0 if k == 0 else 6
            if (got["block_fetch"] + got["resident_fetch"] != want
                    or got["gn_round"] or got["rounds_gn"] != want // 2
                    or (want and ks != {LOC_K})):
                raise AssertionError(f"phase 8 step {k}: launches {got}, "
                                     f"K {ks}")
            registered += k > 0
        timer.sync()
        launches = {n: w.launches for n, w in counted.items()}
    finally:
        tfetch.fetch_rows = real_fetch_rows
        for name in stage_of:
            setattr(tslam, name, real[name])
    events = log.events
    topics = [e["topic"] for e in events]
    print(f"phase 8 launches: {launches} over {N_SLAM} steps; per step "
          f"{per_step[1]}; keyframes {pipe.n_keyframes}; events "
          f"{ {t_: topics.count(t_) for t_ in sorted(set(topics))} }",
          flush=True)
    kinds = sorted({(c["kind"], c["W"], c["Q"]) for c in calls})
    print(f"phase 8 fetch calls (kind, W, Q): {kinds}", flush=True)
    for kind, W in sorted({(c["kind"], c["W"]) for c in calls}):
        sizes = [(c["rows"], c["bytes"]) for c in calls
                 if (c["kind"], c["W"]) == (kind, W)]
        print(f"phase 8 tables {kind} W {W}: {len(sizes)} fetches, rows "
              f"{min(r for r, _ in sizes)}-{max(r for r, _ in sizes)}, "
              f"bytes {min(b for _, b in sizes)}-{max(b for _, b in sizes)}"
              f" (resident cap {tfetch.RESIDENT_TABLE_CAP} B)", flush=True)
    checked, fetch_err = checked_fetches(calls)
    print(f"phase 8 fetches of the first {SLAM_CHECKED} registration steps "
          f"against their plain versions: "
          f"{sum(c['equal'] for c in checked)}/{len(checked)} bitwise equal,"
          f" max_abs_err {fetch_err}", flush=True)
    if not (len(checked) == 6 * SLAM_CHECKED
            and all(c["equal"] for c in checked)):
        raise AssertionError("phase 8: a fetch kernel != its plain version")
    print_frontend_split("phase 8", frontend_split(
        params, [(s_, dsk) for s_, dsk, _, _ in scans[3:8]], dev))
    drops = [e for e in events if e["topic"] == "mapping/dropped_points"]
    by_cap = {}
    for e in drops:
        key = (e["cap"], e["feature"])
        by_cap.setdefault(key, []).append(e.get("dropped",
                                                e.get("dropped_share")))
    print("phase 8 caps (mapping/dropped_points, per cap and feature: "
          "warnings, mean dropped): " + "; ".join(
              f"{c} {f}: {len(v)}, {np.mean(v):.4g}"
              for (c, f), v in sorted(by_cap.items())), flush=True)

    # ---- loop closure ----
    closures = [e for e in events if e["topic"] == "mapping/loop_closure"]
    icps = timer.calls.get("ICP", [])
    icp_iters = [int(out.iterations) for _, _, out in icps]
    icp_fit = [float(out.fitness) for _, _, out in icps]
    print(f"phase 8 loop closure: {len(closures)} accepted of {len(icps)} "
          f"ICP runs; fitness {[round(f_, 5) for f_ in icp_fit]}; reset_id "
          f"{pipe.reset_id}; loop factors {len(pipe.loop_factors)}; first "
          f"accepted {closures[0] if closures else None}", flush=True)
    if not (closures and pipe.reset_id >= 1 and min(icp_fit) <
            params.history_keyframe_fitness_score):
        raise AssertionError("phase 8: no loop closure accepted")
    print(f"phase 8 icp: {launches['icp']} launches for {len(icps)} ICP "
          f"runs (one a run), knn {launches['knn']} launches in the steps",
          flush=True)
    if launches["icp"] != len(icps) or launches["knn"]:
        raise AssertionError(f"phase 8: icp launches {launches['icp']} for "
                             f"{len(icps)} runs, knn {launches['knn']}")
    accepted = [(a, kw) for a, kw, out in icps
                if float(out.fitness) < params.history_keyframe_fitness_score
                and bool(out.converged)]
    ICP_INPUTS["(a) phase 8 loop candidates"] = accepted[0]
    full = [ms for (a, _, _), ms in zip(timer.calls["graph LM"],
                                        timer.ms["graph LM"])
            if a[0].poses.shape[0] == pipe.max_keyframes]
    window = [ms for (a, _, _), ms in zip(timer.calls["graph LM"],
                                          timer.ms["graph LM"])
              if a[0].poses.shape[0] == pipe.opt_window]
    if not full:
        raise AssertionError("phase 8: the full graph was never solved")
    lm_calls = timer.calls["graph LM"]
    print(f"phase 8 pose_graph_lm: {len(lm_calls)} solves, routes "
          f"{ {r: routes.count(r) for r in sorted(set(routes))} }, launches "
          f"route A {launches['pose_graph_lm']}, route B "
          f"{launches['pose_graph_lm_b']}, factor blocks "
          f"{launches['pose_graph_blocks']} (the marginals)", flush=True)
    if not (len(routes) == len(lm_calls) and launches["pose_graph_lm"]
            and launches["pose_graph_blocks"]):
        raise AssertionError(f"phase 8: pose_graph_lm launches {launches}")
    for (a, kw, _), r in zip(lm_calls, routes):
        key = ("(a) phase 8 window" if a[0].poses.shape[0]
               == pipe.opt_window else "(b) phase 8 full graph")
        if key.startswith("(a)") or key not in LM_INPUTS:
            LM_INPUTS[key] = (a[0], kw.get("iterations", 10))

    # ---- accuracy against the ground truth, in the first scan's frame ----
    T0inv = np.linalg.inv(pose6_to_matrix_np(scans[0][2]))
    truth = np.stack([(T0inv @ pose6_to_matrix_np(g_))[:3, 3]
                      for _, _, g_, _ in scans])
    est = np.stack(ests)
    rel = np.linalg.norm(np.diff(est[:, 3:], axis=0)
                         - np.diff(truth, axis=0), axis=1)
    err = np.linalg.norm(est[:, 3:] - truth, axis=1)
    ate = float(np.sqrt((err ** 2).mean()))
    print(f"phase 8 accuracy: relative displacement error max "
          f"{rel.max():.6f} m (bound 0.12), ate_vs_gt_m {ate} (bound 0.1), "
          f"final error {err[-1]:.4f} m, max {err.max():.4f} m; keyframes "
          f"a step {n_kf[:8]}...", flush=True)
    if not (np.isfinite(est).all() and rel.max() < 0.12 and ate < 0.1):
        raise AssertionError(f"phase 8: rel {rel.max()} ate {ate}")

    # ---- the same first steps on the CPU ----
    n_cpu = 1 + SLAM_CHECKED
    pipe_cpu = tslam.SlamPipeline(params, device=cpu)
    pipe_cpu._log = EventLog()
    d_cpu = max(float(np.abs(pipe_cpu.step(raw_of(s_, cpu), t, dsk)
                             - ests[k]).max())
                for k, (s_, dsk, _, t) in enumerate(scans[:n_cpu]))
    print(f"phase 8 card vs CPU: steps 0-{n_cpu - 1} pose |diff| max "
          f"{d_cpu:.3e}", flush=True)
    if not d_cpu <= 1e-4:
        raise AssertionError(f"phase 8: card vs CPU poses differ by {d_cpu}")

    # ---- the exact solver (register_scan_with_params: one exact_gn launch
    # a solve, its host syncs counted) on the first registration steps'
    # local maps, against grid_register_step; its inputs kept for `probe
    # exact_gn` (a) ----
    exact, reg_syncs = [], []
    EXACT_INPUTS.clear()
    ex0, knn0 = tex.exact_gn.launches, tknn.knn.launches
    counted_solve = sync_counter(register_scan_with_params, reg_syncs)
    for (a, kw, out), _ in zip(timer.calls["tables + solve"][:SLAM_CHECKED],
                               range(SLAM_CHECKED)):
        local_map, feats, guess = a
        res = counted_solve(params, feats, local_map, guess)
        EXACT_INPUTS.append(((guess, feats, local_map), exact_kw(params)))
        d = (res.pose6[0] - out.pose6[0]).abs().cpu().numpy()
        exact.append((float(d[3:].max()), float(d[:3].max())))
        q = [int(feats.corner_mask.sum()), int(feats.surf_mask.sum())]
        m = [int(local_map.corner_mask.sum()), int(local_map.surf_mask.sum())]
        print(f"phase 8 exact check: register_scan_with_params vs "
              f"grid_register_step |diff| {d[3:].max():.3e} m "
              f"{d[:3].max():.3e} rad; iterations "
              f"{int(res.iterations[0])} vs {int(out.iterations[0])}; n_corr "
              f"{int(res.n_corr[0])} vs {int(out.n_corr[0])}; live features "
              f"{q}, map points {m}; host syncs in the solve {reg_syncs[-1]}",
              flush=True)
    if not all(t_ <= 3e-3 and r_ <= 3e-3 for t_, r_ in exact):
        raise AssertionError(f"phase 8: exact vs grid {exact}")
    launches["exact_gn"] = tex.exact_gn.launches - ex0
    launches["knn_exact_check"] = tknn.knn.launches - knn0
    print(f"phase 8 exact check: {launches['exact_gn']} exact_gn launches "
          f"and {launches['knn_exact_check']} knn launches in {SLAM_CHECKED}"
          f" solves; host syncs inside a solve {reg_syncs} (torch.cuda sync "
          f"debug mode)", flush=True)
    if launches["exact_gn"] != SLAM_CHECKED or launches["knn_exact_check"]:
        raise AssertionError(f"phase 8: the exact solver made "
                             f"{launches['exact_gn']} exact_gn and "
                             f"{launches['knn_exact_check']} knn launches")
    if any(reg_syncs):
        raise AssertionError(f"phase 8: host syncs in an exact solve "
                             f"{reg_syncs}")

    # ---- the kernel and the plain loop (exact_gn_reference on the card:
    # register_core on knn_stream.cu, a corner and a surf 5-NN an
    # iteration) on the same inputs, in turns; the plain loop's first
    # surf-map k-NN call kept for `probe knn` (c) ----
    knn_calls = []
    real_knn5 = tknn.knn5_points

    def recorded_knn5(q, ref, ref_mask, chunk=4096):
        if len(knn_calls) < 2:
            knn_calls.append(((q, ref, ref_mask), dict(k=5, chunk=chunk)))
        return real_knn5(q, ref, ref_mask, chunk=chunk)

    def host_ms(fn):
        timer.sync()
        t0 = time.perf_counter()
        out = fn()
        timer.sync()
        return (time.perf_counter() - t0) * 1e3, out

    turns, knn_plain = [], tknn.knn.launches
    for n, ((pose, feats, local_map), kw) in enumerate(EXACT_INPUTS):
        def kernel():
            return tex.exact_gn(pose, feats, local_map, **kw)

        def plain():
            return tex.exact_gn_reference(pose, feats, local_map, **kw)

        tknn.knn5_points = recorded_knn5 if n == 0 else real_knn5
        try:
            ms_ = [host_ms(f) for f in (kernel, plain, plain, kernel)]
        finally:
            tknn.knn5_points = real_knn5
        turns.append(([ms_[0][0], ms_[3][0]], [ms_[1][0], ms_[2][0]],
                      ms_[0][1], ms_[1][1]))
    knn_plain = (tknn.knn.launches - knn_plain) // 2
    # corner then surf an iteration: the surf call has the larger map
    KNN_INPUTS["(c) exact solver surf map"] = max(
        knn_calls, key=lambda c: c[0][1].shape[-2])
    same = [bool(torch.equal(sk[:, 6:11], sr[:, 6:11]))
            for _, _, sk, sr in turns]
    dpose = [float((sk[:, :6] - sr[:, :6]).abs().max())
             for _, _, sk, sr in turns]
    EXACT_TURNS.update(
        solves=len(turns), kernel_ms=float(np.mean([t_[0] for t_ in turns])),
        plain_ms=float(np.mean([t_[1] for t_ in turns])),
        kernel_run_ms=[t_[0] for t_ in turns],
        plain_run_ms=[t_[1] for t_ in turns], plain_knn_launches=knn_plain,
        iterations=[int(t_[3][0, 6]) for t_ in turns], equal_flags=same,
        max_abs_err=max(dpose))
    print(f"time phase 8 register_scan in turns (each solve on the exact_gn "
          f"kernel and on the plain loop, exact_gn_reference on the card, "
          f"kernel, plain, plain, kernel; synchronized host clock): kernel "
          f"{EXACT_TURNS['kernel_ms']:.3f} ms a solve "
          f"({[[round(x, 3) for x in t_[0]] for t_ in turns]}), plain loop "
          f"{EXACT_TURNS['plain_ms']:.2f} ms a solve "
          f"({[[round(x, 2) for x in t_[1]] for t_ in turns]}; "
          f"{knn_plain} knn launches a pass); iterations "
          f"{EXACT_TURNS['iterations']}; iterations, n_corr and flags equal "
          f"{same}; pose |diff| {dpose} (held in `probe exact_gn` (a))",
          flush=True)
    if not all(same):
        raise AssertionError(f"phase 8: exact_gn vs the plain loop: flags "
                             f"equal {same}, pose {dpose}")
    split = EXACT_TURNS["plain_split"] = exact_plain_split(*EXACT_INPUTS[0])
    print(f"profile phase 8 plain loop (solve 0 on exact_gn_reference, the "
          f"parent's register_scan route): {split['solve_ms']:.2f} ms a "
          f"solve, {split['iterations']} iterations; an iteration "
          f"(synchronized host clock around each stage): " + ", ".join(
              f"{k} {v:.3f} ms" for k, v in split["iteration_ms"].items())
          + f"; torch.profiler: wall {split['profile']['wall_ms']:.2f} ms, "
          f"device busy {split['profile']['device_busy_ms']:.2f} ms; by "
          f"device time: " + "; ".join(
              f"{n} {ms:.3f}" for n, ms in split["profile"]["top"]),
          flush=True)

    # ---- save -> reload -> relocalize: the middle keyframe's scan, from
    # 0.14 m off, against the saved map, back to that keyframe's pose ----
    map_dir = os.path.join(REPO, "build", "slam_map")
    pipe.save_map(map_dir)
    gm = GlobalMap.from_pcd_dir(params, map_dir, device=dev)
    loc = LocalizationPipeline(params, gm)
    kf_steps = [k for k in range(N_SLAM)
                if n_kf[k] > (n_kf[k - 1] if k else 0)]
    j = len(kf_steps) // 2
    k = kf_steps[j]
    s_, dsk, _, t = scans[k]
    loc.pose = pipe.kf_poses[j] + np.array([0, 0, 0, 0.1, -0.1, 0.0],
                                           np.float32)
    reloc = loc.step(raw_of(s_, dev), t, DeskewInfo(*(a.to(dev)
                                                      for a in dsk)))
    d_reloc = float(np.linalg.norm(reloc[3:] - pipe.kf_poses[j, 3:]))
    print(f"phase 8 save_map -> GlobalMap.from_pcd_dir (corner "
          f"{int(gm.corner_mask.sum())}, surf {int(gm.surf_mask.sum())}) -> "
          f"LocalizationPipeline.step of keyframe {j}'s scan {k} from 0.14 m "
          f"off: {d_reloc:.4f} m from the map's pose (bound 0.06), "
          f"{np.linalg.norm(reloc[3:] - truth[k]):.4f} m from the truth",
          flush=True)
    if not d_reloc < 0.06:
        raise AssertionError(f"phase 8: relocalized {d_reloc} m off")

    # ---- times ----
    steps_ms = np.array(wall[1:])
    split = {name: float(np.sum(v)) / (N_SLAM - 1)
             for name, v in timer.ms.items()}
    print(f"time phase 8 step: {steps_ms.mean():.2f} ms wall a step (steps "
          f"1-{N_SLAM - 1}; p50 {np.median(steps_ms):.2f}, max "
          f"{steps_ms.max():.2f}); per step on average (synchronized host "
          f"clock; graph LM inside keyframe + graph and loop closure, ICP "
          f"and loop submaps inside loop closure): " + ", ".join(
              f"{name} {ms:.2f} ms" for name, ms in split.items()),
          flush=True)
    print(f"time phase 8 graph: window LM {np.mean(window):.2f} ms "
          f"({len(window)} solves of {pipe.opt_window} poses, 8 iterations),"
          f" full graph {np.mean(full):.2f} ms ({len(full)} solves of "
          f"{pipe.max_keyframes} poses, 12 iterations); ICP "
          f"{np.mean(timer.ms['ICP']):.2f} ms a run, iterations {icp_iters}"
          f"; host syncs a step (torch.cuda sync debug mode, steps "
          f"{SLAM_CHECKED + 1}-{N_SLAM - 1}): mean "
          f"{np.mean(syncs[SLAM_CHECKED + 1:]):.1f} min "
          f"{min(syncs[SLAM_CHECKED + 1:])} max "
          f"{max(syncs[SLAM_CHECKED + 1:])}", flush=True)
    print_lm_in_turns("phase 8", lm_calls, N_SLAM - 1, steps_ms.mean())
    solve_in_turns("phase 8", timer.calls["tables + solve"], N_SLAM - 1,
                   float(steps_ms.mean()))
    turns = icp_in_turns(icps)
    ker = sum(t_[0] for t_ in turns) / (N_SLAM - 1)
    pla = sum(t_[1] for t_ in turns) / (N_SLAM - 1)
    ICP_TURNS.update(runs=len(turns), kernel_ms=float(np.mean(
        [t_[0] for t_ in turns])), plain_ms=float(np.mean(
            [t_[1] for t_ in turns])), kernel_iterations=[t_[2] for t_ in turns],
        plain_iterations=[t_[3] for t_ in turns], step_kernel_ms=ker,
        step_plain_ms=pla, max_abs_err=max(t_[4] for t_ in turns))
    if KI_AB:
        ICP_TURNS.update(other_ms=float(np.mean([t_[5] for t_ in turns])),
                         other_run_ms=[t_[5] for t_ in turns],
                         kernel_run_ms=[t_[0] for t_ in turns],
                         bitwise_other=all(t_[6] for t_ in turns))
        print(f"time phase 8 ICP in turns against the other version's kernel "
              f"(--knn-icp-ab): kernel {ICP_TURNS['kernel_ms']:.3f} ms a run "
              f"({[round(t_[0], 3) for t_ in turns]}), other "
              f"{ICP_TURNS['other_ms']:.3f} ms a run "
              f"({[round(t_[5], 3) for t_ in turns]}); outputs bit for bit "
              f"equal {ICP_TURNS['bitwise_other']}", flush=True)
        if not ICP_TURNS["bitwise_other"]:
            raise AssertionError("phase 8: an ICP run differs from the other "
                                 "version's kernel")
    print(f"time phase 8 ICP in turns (every ICP run of the run again, on "
          f"the icp kernel and on the parent's loop, icp_align_reference, "
          f"in turns): {len(turns)} runs, kernel "
          f"{ICP_TURNS['kernel_ms']:.3f} ms a run (iterations "
          f"{ICP_TURNS['kernel_iterations']}), parent's loop "
          f"{ICP_TURNS['plain_ms']:.2f} ms a run (iterations "
          f"{ICP_TURNS['plain_iterations']}); per step kernel {ker:.3f} ms, "
          f"parent's loop {pla:.2f} ms (the step {steps_ms.mean():.2f} ms on "
          f"the kernel, {steps_ms.mean() - ker + pla:.2f} ms with the "
          f"parent's loop in its place); transform |diff| max "
          f"{ICP_TURNS['max_abs_err']:.3e}", flush=True)
    # one window LM solve again (no state change), profiled: how much of
    # it the device is busy, and with what
    g, _ = pipe._window_graph_data()
    wall_p, busy, top = profile_call(
        lambda: tslam.optimize_pose_graph(g, iterations=8))
    print(f"profile phase 8 window LM (torch.profiler): wall {wall_p:.2f} ms"
          f", device busy {busy:.2f} ms ({busy / wall_p:.1%}), {len(top)} "
          f"kernel names; by device time: " + "; ".join(
              f"{name[:60]} {ms:.3f}" for name, ms in top[:6]), flush=True)
    if dev.type == "cuda":
        d = torch.rand(8192, 4096, device=dev) * 100
        ms_key = cuda_ms(lambda: _extract_topk(d, 5), 10)
        ms_sort = cuda_ms(lambda: torch.sort(d, dim=1, stable=True), 10)
        print(f"time phase 8 knn selection on one [8192, 4096] chunk: "
              f"int64-key top-5 {ms_key:.3f} ms, stable sort "
              f"{ms_sort:.3f} ms", flush=True)
    return launches, fetch_err


def device_ops(fn):
    """The device operations (kernels and copies) one call of fn runs, by
    torch.profiler's device events."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.device_type == torch.autograd.DeviceType.CUDA
               for e in prof.events())


def lio_phase(dev):
    """Phase 9: the LIO mode (examples/run.py --mode lio) on the card:
    LioTopology at its run.py capacities, the raw IMU, motion-skewed scans
    and a GPS chain.  Returns (launches {wrapper: count} over the run,
    {kernel: max_abs_err} of the checked fetches)."""
    import copy
    import warnings

    import torch

    from feature_base_pointcloud_registration_tpu_torch.config import Params
    from feature_base_pointcloud_registration_tpu_torch.geom.se3 import (
        euler_from_quat, rot_to_euler)
    from feature_base_pointcloud_registration_tpu_torch.graph.imu_graph import (  # noqa: E501
        optimize_imu_chain)
    from feature_base_pointcloud_registration_tpu_torch.graph.pose_graph import (  # noqa: E501
        optimize_pose_graph)
    from feature_base_pointcloud_registration_tpu_torch.imu.conversion import (
        imu_converter)
    from feature_base_pointcloud_registration_tpu_torch.io.synthetic import (
        SyntheticWorld, constant_twist_platform, simulate_scan)
    from feature_base_pointcloud_registration_tpu_torch.ops import (
        fetch as tfetch)
    from feature_base_pointcloud_registration_tpu_torch.ops.gn_round import (
        gn_round)
    from feature_base_pointcloud_registration_tpu_torch.pipeline import (
        checkpoint as tckpt, imu_odometry as todo, lio as tlio, slam as tslam)
    from feature_base_pointcloud_registration_tpu_torch.pipeline.cloud_info import (  # noqa: E501
        RawScan)
    from feature_base_pointcloud_registration_tpu_torch.pipeline.navsat import (  # noqa: E501
        EkfGps, NavsatTransform)
    from feature_base_pointcloud_registration_tpu_torch.utils.log import (
        EventLog)

    cpu = torch.device("cpu")
    params = Params(pose_cov_threshold=0.0)
    world = SyntheticWorld()
    w_body, v_body = np.array([0.0, 0.0, 0.15]), np.array([1.2, 0.0, 0.0])
    n_in = N_LIO + 2                     # the ScanBuffer holds two back

    # ---- the platform: raw sensor-frame IMU with quaternions, truth ----
    imu, states = constant_twist_platform(
        n_in * LIO_SPACING + 0.3, ext_rot=params.ext_rot,
        ext_rpy=params.ext_rpy, gravity=params.imu_gravity, w_body=w_body,
        v_body=v_body)
    imu_t = np.array([s_[0] for s_ in imu])
    imu_raw = [np.stack([s_[i] for s_ in imu]) for i in (1, 2, 3)]
    _, gyr_l, quat_l, ok = imu_converter(params, *(
        torch.tensor(a, dtype=torch.float32) for a in imu_raw))
    if not bool(ok.all()):
        raise AssertionError("phase 9: imu_converter flagged a sample")
    rpy_l = torch.stack(euler_from_quat(quat_l), -1).numpy()
    gyr_l = gyr_l.numpy()
    gt6 = np.concatenate([
        torch.stack(rot_to_euler(torch.from_numpy(
            np.stack([R for _, R, _ in states]))), -1).numpy(),
        np.stack([p_ for _, _, p_ in states])], 1).astype(np.float32)

    def truth(t):
        return gt6[int(round(t * 100))]

    scans = []
    for k in range(n_in):
        t = k * LIO_SPACING
        i = int(round(t * 100))
        scans.append((t, simulate_scan(
            world, gt6[i], seed=900 + k, spin_rpy_rate=w_body,
            vel_world=states[i][1] @ v_body)))

    # ---- GPS: 1 Hz ENU fixes of the truth, the map frame at a yaw offset
    # in ENU, 0.05 m isotropic noise ----
    rng = np.random.RandomState(9)
    c_, s_ = np.cos(GPS_YAW_OFFSET), np.sin(GPS_YAW_OFFSET)
    enu_of_map = np.array([[c_, s_, 0.0], [-s_, c_, 0.0], [0.0, 0.0, 1.0]])
    anchor = np.array([1520.0, -310.0, 12.0])
    fixes = [(float(t), anchor + enu_of_map @ truth(t)[3:]
              + rng.normal(0, GPS_NOISE, 3))
             for t in np.arange(0.0, (n_in - 1) * LIO_SPACING + 1e-6, 1.0)]

    def feed(topo, ekf, nav, k):
        """Input k: the raw IMU since the last scan, the GPS fixes through
        EkfGps / NavsatTransform into the SLAM queue, the cloud; the LIO
        pose (if the buffer emits one) feeds the EKF."""
        t, sc = scans[k]
        eps = 1e-9
        sel = (imu_t <= t + eps) & (imu_t > t - LIO_SPACING + eps)
        if sel.any():
            topo.handle_imu(imu_t[sel], *(a[sel] for a in imu_raw))
        j = np.nonzero(imu_t <= t + eps)[0][-1]
        ekf.add_imu(t, rpy_l[j], gyr_l[j])
        for tf, enu in fixes:
            if t - LIO_SPACING + eps < tf <= t + eps:
                jf = np.nonzero(imu_t <= tf + eps)[0][-1]
                xyz, cov = nav.handle_fix(
                    tf, enu, [GPS_NOISE ** 2] * 3,
                    imu_yaw=rpy_l[jf][2] - GPS_YAW_OFFSET)
                topo.slam.add_gps(tf, xyz, cov)
        raw = RawScan.from_numpy(sc["xyz"], sc["intensity"], sc["ring"],
                                 sc["time"], device=cpu)._replace(
            valid=torch.from_numpy(sc["valid"]))
        est = topo.handle_cloud(t, raw)
        if est is not None:
            ekf.add_odometry(topo.slam.time_last_processing, est)
        return est

    def topology(device):
        topo = tlio.LioTopology(params, max_keyframes=256, imu_window=16,
                                imu_max_samples=64, device=device)
        topo.slam._log = topo.odo._log = EventLog()
        ekf = EkfGps(device=device)
        stream = []
        push = topo.odom_queue.push

        def recorded_push(t, pose6, reset_id=0):
            stream.append((t, np.array(pose6)))
            push(t, pose6, reset_id=reset_id)
        topo.odom_queue.push = recorded_push
        return topo, ekf, NavsatTransform(ekf), stream

    # ---- the main path, counted and timed ----
    counted = {"block_fetch": tfetch.block_fetch,
               "resident_fetch": tfetch.resident_fetch, "gn_round": gn_round,
               "ring_pick": ring_pick_wrapper(),
               "rounds_gn": rounds_gn_wrapper(), **pose_graph_counters(),
               **imu_counters()}
    real_fetch_rows = tfetch.fetch_rows
    calls, check = [], {"on": False}
    checked_fetch_rows = fetch_recorder(real_fetch_rows, calls, check)
    timer = StageTimer(dev)
    chain_calls, clone_ms = [], {"ms": 0.0}
    topo, ekf, nav, stream = topology(dev)
    log = topo.slam._log
    odo = topo.odo
    module_fns = [(tslam, "process_scan", "frontend"),
                  (tslam, "grid_register_step", "tables + solve"),
                  (tslam, "optimize_pose_graph", "pose graph LM"),
                  (todo, "preintegrate", "preintegrate"),
                  (todo, "optimize_imu_chain", "chain LM"),
                  (todo, "state_marginal_covariance", "window reset marginal"),
                  (todo, "propagate_states", "propagate")]
    real = {(m, n): getattr(m, n) for m, n, _ in module_fns}
    routes = []
    for m, n, stage in module_fns:
        timed = timer.wrap(stage, lm_route_recorder(
            real[(m, n)], routes) if n == "optimize_pose_graph"
            else real[(m, n)])
        # the chain data cloned outside the stage's timing
        setattr(m, n, chain_recorder(timed, chain_calls, clone_ms)
                if n == "optimize_imu_chain" else timed)
    timed_handle = timer.wrap("handle_odometry", odo.handle_odometry)
    profiled = {}

    def handle_odometry(*a, **kw):
        if (len(ests) >= LIO_PROFILED and not profiled
                and odo.system_initialized
                and kw.get("reset_id") == odo.reset_id):
            # the odometry as it is before this correction (a full one: no
            # re-initialization), for the profile
            t0 = time.perf_counter()
            c_ = copy.deepcopy(odo)
            for name in ("handle_odometry", "flush_imu_odometry",
                         "_reset_window"):
                c_.__dict__.pop(name)
            profiled.update(odo=c_, args=(a, kw),
                            copy_ms=(time.perf_counter() - t0) * 1e3)
        return timed_handle(*a, **kw)
    odo.handle_odometry = handle_odometry
    odo.flush_imu_odometry = timer.wrap("flush_imu_odometry",
                                        odo.flush_imu_odometry)
    resets, reset_at = [], []
    reset_window = odo._reset_window

    def counted_reset():
        resets.append((odo.key, getattr(odo, "_last_chain_data", None)
                       is not None))
        reset_at.append(len(chain_calls))
        reset_window()
    odo._reset_window = counted_reset
    # the SLAM calls in order (add_gps and step), for the resume check
    slam_calls = []
    slam_step = timer.wrap("slam step", topo.slam.step)
    slam_gps = topo.slam.add_gps

    def recorded_step(*a, **kw):
        out = slam_step(*a, **kw)
        slam_calls.append(("step", a, kw, out.copy()))
        return out

    def recorded_gps(*a):
        slam_calls.append(("gps", a, {}, None))
        slam_gps(*a)
    topo.slam.step, topo.slam.add_gps = recorded_step, recorded_gps

    ckpt_dir = os.path.join(REPO, "build", "lio_checkpoint")
    ckpt_at = None
    ests, t_ests, wall, per_step, syncs, stage_ms = [], [], [], [], [], []
    n_kf_at = []
    tfetch.fetch_rows = checked_fetch_rows
    try:
        timer.sync()
        for w in counted.values():
            w.launches = 0
        registered = 0
        for k in range(n_in):
            check["on"] = registered < LIO_CHECKED
            before = {n_: w.launches for n_, w in counted.items()}
            n_calls = len(calls)
            kf_before = topo.slam.n_keyframes
            copied = bool(profiled)
            stages0 = {n_: sum(v) for n_, v in timer.ms.items()}
            clone0 = clone_ms["ms"]
            timer.sync()
            t0 = time.perf_counter()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    est = feed(topo, ekf, nav, k)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            timer.sync()
            got = {n_: w.launches - before[n_] for n_, w in counted.items()}
            ks = {c["K"] for c in calls[n_calls:]}
            if est is None:
                if any(got.values()):
                    raise AssertionError(f"phase 9 input {k}: launches {got}"
                                         " before the buffer emitted")
                continue
            # the profile's copy of the odometry and the chain data's
            # clones for the replay in turns are not the step's work
            wall.append((time.perf_counter() - t0) * 1e3 - (
                profiled["copy_ms"] if profiled and not copied else 0.0)
                - (clone_ms["ms"] - clone0))
            stage_ms.append({n_: sum(v) - stages0.get(n_, 0.0)
                             for n_, v in timer.ms.items()})
            syncs.append(sum("synchroniz" in str(w_.message)
                             for w_ in caught))
            ests.append(est.copy())
            t_ests.append(topo.slam.time_last_processing)
            n_kf_at.append(topo.slam.n_keyframes)
            per_step.append(got)
            want = 6 if kf_before else 0
            if (got["block_fetch"] + got["resident_fetch"] != want
                    or got["gn_round"] or got["rounds_gn"] != want // 2
                    or (want and ks != {LOC_K})):
                raise AssertionError(f"phase 9 step {len(ests)}: launches "
                                     f"{got}, K {ks}")
            # the IMU correction: one chain LM and one preintegration (none
            # at the initialization), a marginal's blocks at a window
            # reset, a flush's and a re-propagation's propagate
            if not (got["imu_chain_lm"] == got["preintegrate"] <= 1
                    and got["imu_chain_blocks"] <= got["imu_chain_lm"]
                    and got["propagate_states"] <= 2):
                raise AssertionError(f"phase 9 step {len(ests)}: IMU "
                                     f"launches {got}")
            registered += want > 0
            if len(ests) == LIO_CKPT:
                tckpt.save_checkpoint(topo.slam, ckpt_dir)
                ckpt_at = len(slam_calls)
            if len(ests) == LIO_CHECKED + 1:
                # the stages' totals before the steps that are timed
                timed_from = {n_: sum(v) for n_, v in timer.ms.items()}
        timer.sync()
        launches = {n_: w.launches for n_, w in counted.items()}
    finally:
        tfetch.fetch_rows = real_fetch_rows
        for m, n, _ in module_fns:
            setattr(m, n, real[(m, n)])
    events = log.events
    topics = [e["topic"] for e in events]
    print(f"phase 9 launches: {launches} over {len(ests)} LIO steps "
          f"({n_in} scans in); per step {per_step[1]}; keyframes "
          f"{topo.slam.n_keyframes}; events "
          f"{ {t_: topics.count(t_) for t_ in sorted(set(topics))} }; "
          f"pose graph solves {len(routes)}, routes "
          f"{ {r: routes.count(r) for r in sorted(set(routes))} }",
          flush=True)
    if not (routes and launches["pose_graph_lm"] + launches[
            "pose_graph_lm_b"] and launches["pose_graph_blocks"]):
        raise AssertionError(f"phase 9: pose_graph_lm launches {launches}")
    for kind, W in sorted({(c["kind"], c["W"]) for c in calls}):
        sizes = [(c["rows"], c["bytes"]) for c in calls
                 if (c["kind"], c["W"]) == (kind, W)]
        print(f"phase 9 tables {kind} W {W}: {len(sizes)} fetches, rows "
              f"{min(r for r, _ in sizes)}-{max(r for r, _ in sizes)}, "
              f"bytes {min(b for _, b in sizes)}-{max(b for _, b in sizes)}"
              f" (resident cap {tfetch.RESIDENT_TABLE_CAP} B)", flush=True)
    checked, fetch_err = checked_fetches(calls)
    print(f"phase 9 fetches of the first {LIO_CHECKED} registration steps "
          f"against their plain versions: "
          f"{sum(c['equal'] for c in checked)}/{len(checked)} bitwise equal,"
          f" max_abs_err {fetch_err}", flush=True)
    if not (len(checked) == 6 * LIO_CHECKED
            and all(c["equal"] for c in checked)):
        raise AssertionError("phase 9: a fetch kernel != its plain version")

    # ---- the IMU chain, GPS, the caps ----
    n_marginal = sum(m for _, m in resets)
    gps = [e for e in events if e["topic"] == "mapping/gps_factor"]
    failures = [e for e in events if e["topic"] == "imu/failure_reset"]
    dropped_imu = [e for e in events if e["topic"] == "imu/dropped_samples"]
    print(f"phase 9 IMU chain: {len(timer.calls['handle_odometry'])} "
          f"corrections, window resets at keys {[k_ for k_, _ in resets]} "
          f"({n_marginal} carrying the marginal), re-initializations by the "
          f"reset-id protocol {topics.count('imu/reset_id_mismatch')}, "
          f"failure resets {len(failures)}, key {odo.key}, reset_id "
          f"{odo.reset_id}, done_first_opt {odo.done_first_opt}; GPS "
          f"factors {len(gps)} ({[(e['time'], e['keyframe']) for e in gps]}"
          f"), fixes {len(fixes)}, SLAM reset_id {topo.slam.reset_id}",
          flush=True)
    by_cap = {}
    for e in events:
        if e["topic"].endswith("/dropped_points"):
            key = (e["cap"], e["feature"])
            by_cap.setdefault(key, []).append(
                e.get("dropped", e.get("dropped_share")))
    print(f"phase 9 caps: imu/dropped_samples {len(dropped_imu)} (cap "
          f"{odo.max_samples}); mapping/dropped_points (per cap and "
          "feature: warnings, mean dropped): " + "; ".join(
              f"{c} {f}: {len(v)}, {np.mean(v):.4g}"
              for (c, f), v in sorted(by_cap.items())), flush=True)
    if not (n_marginal >= 2 and odo.done_first_opt and not failures):
        raise AssertionError(f"phase 9: IMU chain resets {resets}, "
                             f"failures {len(failures)}")
    if not gps:
        raise AssertionError("phase 9: no GPS factor")
    flushes = sum(out is not None
                  for _, _, out in timer.calls["flush_imu_odometry"])
    n_corr = len(timer.calls["chain LM"])
    n_prop = len(timer.calls["propagate"])
    print(f"phase 9 IMU kernels: {n_corr} corrections, imu_chain_lm "
          f"{launches['imu_chain_lm']} launches, preintegrate "
          f"{launches['preintegrate']}, imu_chain_blocks "
          f"{launches['imu_chain_blocks']} ({n_marginal} window resets "
          f"through the marginal), propagate_states "
          f"{launches['propagate_states']} ({flushes} flushes, "
          f"{n_prop - flushes} re-propagations)", flush=True)
    if not (launches["imu_chain_lm"] == launches["preintegrate"] == n_corr
            == len(chain_calls) == len(timer.calls["preintegrate"]) > 0
            and launches["imu_chain_blocks"] == n_marginal
            and launches["propagate_states"] == n_prop > flushes > 0):
        raise AssertionError(f"phase 9: IMU launches {launches}, "
                             f"corrections {n_corr}, propagations "
                             f"{n_prop}, flushes {flushes}")
    full = [a[0] for a, _, _ in chain_calls if bool(a[0].state_mask.all())]
    after = chain_calls[reset_at[0]][0][0]
    if not (full and int(after.state_mask.sum()) == 2):
        raise AssertionError("phase 9: no full window or reset window kept")
    IMU_INPUTS["(a) phase 9 last full window"] = full[-1]
    IMU_INPUTS["(b) phase 9 first correction after a reset"] = after
    IMU_INPUTS["preintegrate"] = timer.calls["preintegrate"][-1][:2]
    IMU_INPUTS["propagate"] = timer.calls["propagate"][-1][:2]
    IMU_INPUTS["phase9_calls"] = dict(
        preintegrate=[c[:2] for c in timer.calls["preintegrate"]],
        propagate=[c[:2] for c in timer.calls["propagate"]], steps=len(ests))

    # ---- accuracy against the truth (the map frame is the truth's) ----
    est = np.stack(ests)
    tru = np.stack([truth(t)[3:] for t in t_ests])
    rel = np.linalg.norm(np.diff(est[:, 3:], axis=0) - np.diff(tru, axis=0),
                         axis=1)
    err = np.linalg.norm(est[:, 3:] - tru, axis=1)
    ate = float(np.sqrt((err ** 2).mean()))
    # the IMU-rate odometry against the truth, and against the LIO
    # trajectory that corrects it (positions interpolated between steps):
    # it cannot be nearer the truth than its corrections
    ts_s = np.array([t for t, _ in stream])
    ps = np.stack([p6[3:] for _, p6 in stream])
    odo_gt = np.linalg.norm(ps - np.stack([truth(t)[3:] for t in ts_s]),
                            axis=1)
    inside = ts_s <= t_ests[-1]
    lio_at = np.stack([np.interp(ts_s[inside], t_ests, est[:, i])
                       for i in (3, 4, 5)], 1)
    odo_lio = np.linalg.norm(ps[inside] - lio_at, axis=1)
    print(f"phase 9 accuracy: relative displacement error max (steps 2-) "
          f"{rel[1:].max():.6f} m (bound 0.12), max translation error "
          f"{err.max():.4f} m (bound 0.15), ate_vs_gt_m {ate}, final error "
          f"{err[-1]:.4f} m; IMU-rate odometry ({len(ps)} samples) median "
          f"position error against the truth {np.median(odo_gt):.4f} m (max "
          f"{odo_gt.max():.4f}), against the LIO trajectory "
          f"{np.median(odo_lio):.4f} m (bound 0.05; max "
          f"{odo_lio.max():.4f})", flush=True)
    if not (np.isfinite(est).all() and rel[1:].max() < 0.12
            and err.max() < 0.15 and np.median(odo_lio) < 0.05):
        raise AssertionError(f"phase 9: rel {rel[1:].max()} err "
                             f"{err.max()} odometry {np.median(odo_lio)}")

    # ---- the same first steps on the CPU ----
    topo_c, ekf_c, nav_c, stream_c = topology(cpu)
    ests_c, k = [], 0
    while len(ests_c) < LIO_CPU:
        e_ = feed(topo_c, ekf_c, nav_c, k)
        if e_ is not None:
            ests_c.append(e_.copy())
        k += 1
    d_pose = float(np.abs(np.stack(ests_c) - est[:LIO_CPU]).max())
    n_s = len(stream_c)
    d_stream = (float(np.abs(np.stack([p for _, p in stream_c])
                             - np.stack([p for _, p in stream[:n_s]])).max())
                if n_s else 0.0)
    same_t = [t for t, _ in stream_c] == [t for t, _ in stream[:n_s]]
    print(f"phase 9 card vs CPU: steps 0-{LIO_CPU - 1} pose |diff| max "
          f"{d_pose:.3e}; IMU-rate odometry up to them ({n_s} samples, same "
          f"times {same_t}) |diff| max {d_stream:.3e}", flush=True)
    if not (d_pose <= 1e-4 and d_stream <= 1e-4 and same_t and n_s > 0):
        raise AssertionError(f"phase 9: card vs CPU {d_pose} {d_stream}")

    # ---- resume on the card: the checkpoint at step LIO_CKPT into a fresh
    # SlamPipeline, then the same SLAM calls ----
    pipe = tslam.SlamPipeline(params, max_keyframes=256, device=dev)
    pipe._log = EventLog()
    tckpt.load_checkpoint(pipe, ckpt_dir)
    replay = [c for c in slam_calls[ckpt_at:]]
    d_res, equal, n_steps = 0.0, True, 0
    for kind, a, kw, out in replay:
        if kind == "gps":
            pipe.add_gps(*a)
            continue
        got_ = pipe.step(*a, **kw)
        d_res = max(d_res, float(np.abs(got_ - out).max()))
        equal &= bool(np.array_equal(got_, out))
        n_steps += 1
        if n_steps == LIO_RESUMED:
            break
    g, _ = pipe._window_graph_data()
    lm = [optimize_pose_graph(g, iterations=8)[0] for _ in range(2)]
    chain = odo._last_chain_data
    ch = [optimize_imu_chain(chain, iterations=4)[0] for _ in range(2)]
    print(f"phase 9 resume: checkpoint after step {LIO_CKPT} loaded into a "
          f"fresh SlamPipeline on the card, {n_steps} steps: bitwise "
          f"{equal}, pose |diff| max {d_res:.3e} (bound 1e-5); repeated on "
          f"the same inputs, the window pose-graph LM (the pose_graph_lm "
          f"kernel) bitwise {torch.equal(lm[0], lm[1])}, the IMU chain "
          f"LM (the imu_chain_lm kernel) bitwise "
          f"{torch.equal(ch[0], ch[1])}", flush=True)
    if not (n_steps == LIO_RESUMED and d_res <= 1e-5):
        raise AssertionError(f"phase 9: resumed {n_steps} steps, {d_res}")

    # ---- times ----
    steps_ms = np.array(wall[LIO_CHECKED + 1:])
    n_t = len(ests)
    split = {name: (float(np.sum(v)) - timed_from.get(name, 0.0))
             / len(steps_ms) for name, v in timer.ms.items()}
    print(f"time phase 9 step: {steps_ms.mean():.2f} ms wall a LIO step "
          f"(handle_imu + GPS + handle_cloud; steps {LIO_CHECKED + 1}-"
          f"{n_t - 1}; p50 {np.median(steps_ms):.2f}, max "
          f"{steps_ms.max():.2f}); per step on average (synchronized host "
          f"clock; frontend and tables + solve inside slam step; "
          f"preintegrate, chain LM, the "
          f"window reset's marginal and the re-propagation inside "
          f"handle_odometry; propagate also inside flush_imu_odometry): "
          + ", ".join(f"{name} {ms:.2f} ms" for name, ms in split.items())
          + f"; host syncs a step (torch.cuda sync debug mode): mean "
          f"{np.mean(syncs[LIO_CHECKED + 1:]):.1f} min "
          f"{min(syncs[LIO_CHECKED + 1:])} max "
          f"{max(syncs[LIO_CHECKED + 1:])}", flush=True)
    print_lm_in_turns("phase 9", timer.calls["pose graph LM"], len(ests),
                      steps_ms.mean())
    k_step, p_step = print_lm_in_turns("phase 9", chain_calls, len(ests),
                                       steps_ms.mean(), lm="imu_chain_lm")
    solve_in_turns("phase 9", timer.calls["tables + solve"], len(ests),
                   float(steps_ms.mean()))
    IMU_INPUTS["in_turns"] = dict(kernel_ms_step=k_step,
                                  parent_loop_ms_step=p_step,
                                  lio_step_ms=float(steps_ms.mean()))
    worst = LIO_CHECKED + 1 + int(np.argmax(steps_ms))
    print(f"time phase 9 slowest step: step {worst} (t {t_ests[worst]:.1f}"
          f" s) {wall[worst]:.2f} ms: " + ", ".join(
              f"{name} {ms:.2f} ms" for name, ms in stage_ms[worst].items()
              if ms > 0) + f"; keyframes after it "
          f"{n_kf_at[worst]}", flush=True)
    a, kw, _ = timer.calls["preintegrate"][-1]
    n_live = a[0].shape[0]
    w_pre, b_pre, top_pre = profile_call(lambda: todo.preintegrate(*a, **kw))
    ms_pre = cuda_ms(lambda: todo.preintegrate(*a, **kw), 5)
    a2, kw2, _ = timer.calls["chain LM"][-1]
    w_lm, b_lm, top_lm = profile_call(
        lambda: todo.optimize_imu_chain(*a2, **kw2))
    ms_lm = cuda_ms(lambda: todo.optimize_imu_chain(*a2, **kw2), 3)
    print(f"time phase 9 IMU: one preintegration of {n_live} samples "
          f"{ms_pre:.2f} ms (CUDA events; profiled wall {w_pre:.2f} ms, "
          f"device busy {b_pre:.3f} ms, "
          f"{sum(1 for _ in top_pre)} kernel names); one chain LM (window "
          f"{odo.window}, 4 iterations) {ms_lm:.2f} ms (profiled wall "
          f"{w_lm:.2f} ms, device busy {b_lm:.3f} ms)", flush=True)
    print(f"launches phase 9 IMU: one preintegration "
          f"{device_ops(lambda: todo.preintegrate(*a, **kw))} device "
          f"operations ({n_live} samples), one chain LM "
          f"{device_ops(lambda: todo.optimize_imu_chain(*a2, **kw2))} "
          f"(kernels and copies, torch.profiler)", flush=True)
    # one correction again, from the odometry as it was before step
    # LIO_PROFILED's, profiled: how much of it the device is busy
    a3, kw3 = profiled["args"]
    wall_p, busy, top = profile_call(
        lambda: profiled["odo"].handle_odometry(*a3, **kw3))
    print(f"profile phase 9 handle_odometry (torch.profiler): wall "
          f"{wall_p:.2f} ms, device busy {busy:.2f} ms "
          f"({busy / wall_p:.1%}), {len(top)} kernel names; by device "
          f"time: " + "; ".join(f"{name[:50]} {ms:.3f}"
                               for name, ms in top[:5]), flush=True)
    return launches, fetch_err

@contextlib.contextmanager
def coarse_stages(timer):
    """Time the stages of a coarse alignment (FPFH, match, RANSAC, ICP) in
    `timer` (a StageTimer) while the block runs: the module functions that
    ops.ransac.coarse_align_fpfh, examples/run_kitti.py and
    pipeline/multisession.py call are wrapped, and restored after."""
    from feature_base_pointcloud_registration_tpu_torch.ops import (
        fpfh as tfpfh, icp as ticp, ransac as transac)
    from feature_base_pointcloud_registration_tpu_torch.pipeline import (
        multisession as tms)
    patched = [(tfpfh, "fpfh", "FPFH"),
               (tfpfh, "match_descriptors", "match"),
               (transac, "ransac_align", "RANSAC"),
               (ticp, "icp_align", "ICP"), (tms, "icp_align", "ICP")]
    saved = [getattr(m, a) for m, a, _ in patched]
    for (m, a, name), fn in zip(patched, saved):
        setattr(m, a, timer.wrap(name, fn))
    try:
        yield timer
    finally:
        for (m, a, _), fn in zip(patched, saved):
            setattr(m, a, fn)


def fpfh_bins(pts, mask, k=16, chunk=2048):
    """The K-NN of the FPFH of pts (its indices [N, k], on the host) and the
    histogram bins of each pair's three Darboux angles (int [3, N, k]), as
    ops/fpfh.fpfh computes them."""
    import torch

    from feature_base_pointcloud_registration_tpu_torch.ops import (
        fpfh as tfpfh, knn as tknn)
    d2, idx = tknn.knn(pts, pts, mask, k=k, chunk=chunk)
    idx = idx.long()
    n, _ = tfpfh._normals(pts, mask, d2, idx, None)
    angles = tfpfh._pair_features(pts, n, pts[idx], n[idx])[:3]
    return idx.cpu(), torch.stack([
        torch.clamp(((a - lo) / (hi - lo) * tfpfh.N_BINS).to(torch.int32),
                    0, tfpfh.N_BINS - 1).cpu()
        for a, (lo, hi) in zip(angles, ((-1, 1), (-1, 1),
                                        (-np.pi, np.pi)))])


def pair_card_vs_cpu(dev, src_xyz, dst_xyz, cap=2048, leaf=0.3):
    """run_kitti's pair alignment stage by stage, card against CPU: FPFH
    within 1e-5 wherever neither the neighbor set differs (at exact-distance
    ties, within 1e-3 m^2) nor a histogram bin flipped (a flip at a point
    changes its descriptor and its neighbors').  Flips come from normals
    that rounding turns, at points whose neighborhood is near a line (on a
    ring scan, about half the points); flips at no such point are bounded
    by 0.1% of the pairs.  RANSAC scoring of the same triplets and ICP from
    the same coarse transform within 1e-4."""
    import torch

    from feature_base_pointcloud_registration_tpu_torch import native
    from feature_base_pointcloud_registration_tpu_torch.ops import (
        fpfh as tfpfh, icp as ticp, ransac as transac)

    cpu = torch.device("cpu")
    runs = []
    for d_ in (dev, cpu):
        run = []
        for xyz in (src_xyz, dst_xyz):
            pts = native.voxel_downsample(xyz, leaf)[:cap]
            buf = np.zeros((cap, 3), np.float32)
            buf[:len(pts)] = pts
            x = torch.from_numpy(buf).to(d_)
            m = (torch.arange(cap) < len(pts)).to(d_)
            run.append((x, m, *tfpfh.fpfh(x, m), *fpfh_bins(x, m)))
        runs.append(run)
    flips, flips_out, n_ill, n_pairs, err, other, tie = 0, 0, 0, 0, 0.0, 0, 0.0
    for (x, m, desc, v, idx, bins), (x_c, _, desc_c, v_c, idx_c, bins_c) in (
            zip(*runs)):
        if not torch.equal(v.cpu(), v_c):
            raise AssertionError("phase 10 (c): FPFH valid card != CPU")
        # another neighbor set (the streamed d2 differs by float32 noise):
        # the two sets' exact distances must agree (ties of the grid-like
        # voxel centroids of a ring scan)
        nb = (idx != idx_c).any(1)
        p64 = x_c.double()
        for a in (idx, idx_c):
            a_d = ((p64[a[nb]] - p64[nb][:, None]) ** 2).sum(-1)
            a_d = a_d.sort(1).values
            if a is idx:
                card_d = a_d
        tie = max(tie, float((card_d - a_d).abs().max()) if nb.any()
                  else 0.0)
        flip = (bins != bins_c).any(0) & (idx == idx_c)
        at = nb | flip.any(1)
        touched = at | at[idx_c].any(1)
        # a point whose neighborhood is near a line (a ring of the scan: the
        # two smallest covariance eigenvalues within 5% of the largest) has
        # a normal that any rounding turns: its pairs may flip
        dev_ = p64[idx_c] - p64[idx_c].mean(1, keepdim=True)
        cov = torch.einsum("nki,nkj->nij", dev_, dev_)
        lam = torch.linalg.eigvalsh(cov)
        ill = (lam[:, 1] - lam[:, 0]) < 0.05 * lam[:, 2]
        ill_pair = ill[:, None] | ill[idx_c]
        flips += int(flip.sum())
        flips_out += int((flip & ~ill_pair).sum())
        n_ill += int(ill[m.cpu()].sum())
        other += int(nb.sum())
        n_pairs += flip.numel()
        err = max(err, float((desc.cpu() - desc_c)[~touched].abs().max()))
    (xs, ms_, sd, sv, *_), (xd, md, dd, dv, *_) = runs[1]
    midx, sim = tfpfh.match_descriptors(sd, sv, dd, dv)
    corr = sv & (sim > -torch.inf)
    samples = transac.sample_triplets(torch.Generator().manual_seed(0),
                                      corr, 256)
    fits, icps = [], []
    for (s_, _, *_), (d_, _, *_) in runs:
        dv_ = s_.device
        fits.append(transac.ransac_from_samples(
            samples.to(dv_), s_, d_[midx.long().to(dv_)], corr.to(dv_),
            inlier_threshold=0.5))
    for (s_, sm_, *_), (d_, dm_, *_) in runs:
        T = fits[1].transform.to(s_.device)
        icps.append(ticp.icp_align(s_ @ T[:3, :3].T + T[:3, 3], sm_, d_, dm_,
                                   max_corr_dist=2.0, max_iterations=50))
    d_fit = float((fits[0].transform.cpu() - fits[1].transform).abs().max())
    d_icp = float((icps[0].transform.cpu() - icps[1].transform).abs().max())
    print(f"phase 10 (c) pair 0->1 card vs CPU: FPFH neighbor sets "
          f"differing at ties {other} of {n_pairs // 16} points (their exact "
          f"squared distances |diff| max {tie:.3e} m^2), bin flips {flips} "
          f"of {n_pairs} pairs, {flips_out} of them at no ill-conditioned "
          f"normal ({n_ill} live points near a line), descriptors |diff| max"
          f" {err:.3e} where neither touched; RANSAC on the same triplets "
          f"|diff| "
          f"{d_fit:.3e}, inliers {int(fits[0].inliers)} / "
          f"{int(fits[1].inliers)}; ICP from the CPU's coarse |diff| "
          f"{d_icp:.3e}", flush=True)
    if not (flips_out <= 1e-3 * n_pairs and tie <= 1e-3 and err <= 1e-5
            and d_fit <= 1e-4 and d_icp <= 1e-4
            and abs(int(fits[0].inliers) - int(fits[1].inliers)) <= 1):
        raise AssertionError("phase 10 (c): pair card != CPU")


def kitti_phase(dev):
    """Phase 10 (a)-(c): KITTI raw I/O, examples/run_kitti_slam.py's
    generated drive and examples/run_kitti.py's pair alignment on the card.
    Returns (launches {wrapper: count} over the SLAM run, {kernel:
    max_abs_err} of its checked fetches)."""
    import tempfile

    import torch

    from feature_base_pointcloud_registration_tpu_torch import native
    from feature_base_pointcloud_registration_tpu_torch.config import Params
    from feature_base_pointcloud_registration_tpu_torch.examples import (
        run_kitti, run_kitti_slam)
    from feature_base_pointcloud_registration_tpu_torch.io import (
        kitti, kitti_drive)
    from feature_base_pointcloud_registration_tpu_torch.ops import (
        fetch as tfetch)
    from feature_base_pointcloud_registration_tpu_torch.ops.features import (
        extract_features)
    from feature_base_pointcloud_registration_tpu_torch.ops.gn_round import (
        gn_round)
    from feature_base_pointcloud_registration_tpu_torch.ops.projection import (
        project_scan)
    from feature_base_pointcloud_registration_tpu_torch.pipeline import (
        slam as tslam)
    from feature_base_pointcloud_registration_tpu_torch.pipeline.cloud_info import (  # noqa: E501
        RawScan)

    cpu = torch.device("cpu")
    # ---- (a) KITTI I/O: the loader against the host decode, bitwise; the
    # HDL-64 frontend of run_kitti_slam's Params, card against CPU ----
    vdir = os.path.join(REPO, "tests", "data", "kitti_mini",
                        "velodyne_points", "data")
    paths = kitti.scan_files(vdir)
    hdl64 = Params(n_scan=64, horizon_scan=1800, corner_cap=7680,
                   surf_cap=32768, sector_cap=304, map_corner_cap=16384,
                   map_surf_cap=131072, mapping_process_interval=0.0)
    cap = 1 << 17
    loaded = [kitti.load_scan(p, cap, device=dev) for p in paths]
    streamed = list(kitti.iter_scans(vdir, cap, device=dev))
    n_feat = []
    for p, a, b in zip(paths, loaded, streamed):
        d = native.kitti_read_bin(p)
        n = len(d["xyz"])
        want = RawScan.from_numpy(d["xyz"], d["intensity"], d["ring"],
                                  d["time"], max_points=cap, device=cpu)
        valid = np.zeros(cap, bool)
        valid[:n] = d["valid"] & (d["ring"] >= 0)
        want = want._replace(valid=torch.from_numpy(valid))
        for got in (a, b):
            if not all(torch.equal(g.cpu(), w) for g, w in zip(got, want)):
                raise AssertionError(f"phase 10 (a): {p} != host decode")
        feats = [extract_features(hdl64, project_scan(
            hdl64, RawScan(*(t.to(d_)[None] for t in a))), strict=True)
            for d_ in (dev, cpu)]
        if not all(torch.equal(x.cpu(), y) for x, y in zip(*feats)):
            raise AssertionError(f"phase 10 (a): {p} features card != CPU")
        n_feat.append((n, int(feats[1].corner_mask.sum()),
                       int(feats[1].surf_mask.sum())))
    print(f"phase 10 (a) KITTI I/O: {len(paths)} HDL-64 scans of "
          f"tests/data/kitti_mini, load_scan and iter_scans on the card "
          f"bitwise equal to native.kitti_read_bin; strict features at "
          f"run_kitti_slam's HDL-64 Params card == CPU (points, corner, "
          f"surf): {n_feat}", flush=True)

    with tempfile.TemporaryDirectory() as drive:
        # ---- (b) run_kitti_slam's generated drive, --gps --navsat ----
        t0 = time.perf_counter()
        kitti_drive.make_drive(drive, n_scans=N_KITTI)
        t_gen = time.perf_counter() - t0
        slam_args = ["--data", drive, "--sensor", "vlp16", "--gps",
                     "--navsat", "--pose-cov-threshold", "0", "--device",
                     dev.type]
        # warm-up, not counted: the first solves on the card load its
        # libraries (the first Cholesky took seconds in a first call)
        run_kitti_slam.main(slam_args + ["--scans", "3"])
        counted = {"block_fetch": tfetch.block_fetch,
                   "resident_fetch": tfetch.resident_fetch,
                   "gn_round": gn_round, "rounds_gn": rounds_gn_wrapper()}
        real = {name: getattr(tslam, name) for name in (
            "process_scan", "grid_register_step", "optimize_pose_graph")}
        real_fetch_rows = tfetch.fetch_rows
        calls, check = [], {"on": False}
        timer = StageTimer(dev)
        per_reg = []

        def registration(*a, **kw):
            check["on"] = len(per_reg) < KITTI_CHECKED
            before = {n_: w.launches for n_, w in counted.items()}
            out = timer.wrap("registration", real["grid_register_step"])(
                *a, **kw)
            per_reg.append({n_: w.launches - before[n_]
                            for n_, w in counted.items()})
            return out

        tslam.process_scan = timer.wrap("frontend", real["process_scan"])
        tslam.grid_register_step = registration
        routes = []
        tslam.optimize_pose_graph = timer.wrap("graph", lm_route_recorder(
            real["optimize_pose_graph"], routes))
        tfetch.fetch_rows = fetch_recorder(real_fetch_rows, calls, check)
        picks = ring_pick_wrapper()
        lm_counts = {**pose_graph_counters(), **knn_icp_counters()}
        try:
            timer.sync()
            for w in (*counted.values(), picks, *lm_counts.values()):
                w.launches = 0
            out = run_kitti_slam.main(slam_args + ["--scans", str(N_KITTI)])
            timer.sync()
            launches = {n_: w.launches for n_, w in counted.items()}
            launches["ring_pick"] = picks.launches
            launches.update({n_: w.launches for n_, w in lm_counts.items()})
        finally:
            tfetch.fetch_rows = real_fetch_rows
            for name, fn in real.items():
                setattr(tslam, name, fn)
        pipe = out["pipe"]
        n_gps = len(pipe.gps_factors)
        print(f"phase 10 (b) KITTI SLAM: {N_KITTI} VLP-16 scans of the "
              f"generated drive (written in {t_gen:.2f} s), launches "
              f"{launches}; per registration step {per_reg[1]}; "
              f"{len(per_reg)} registration steps; keyframes "
              f"{pipe.n_keyframes}; GPS factors {n_gps} (events "
              f"{out['counts']}); ATE vs oxts {out['ate']:.4f} m (bound "
              f"{KITTI_ATE_BOUND})", flush=True)
        if any(r != {"block_fetch": r["block_fetch"],
                     "resident_fetch": r["resident_fetch"], "gn_round": 0,
                     "rounds_gn": 3}
               or r["block_fetch"] + r["resident_fetch"] != 6
               for r in per_reg) or len(per_reg) != N_KITTI - 1:
            raise AssertionError(f"phase 10 (b): launches {per_reg}")
        if {c["K"] for c in calls} != {LOC_K}:
            raise AssertionError("phase 10 (b): a fetch not at K=16")
        print(f"phase 10 (b) pose graph solves {len(routes)}, routes "
              f"{ {r: routes.count(r) for r in sorted(set(routes))} }",
              flush=True)
        if not (routes and launches["pose_graph_lm"]
                + launches["pose_graph_lm_b"]):
            raise AssertionError(f"phase 10 (b): pose_graph_lm {launches}")
        kinds = sorted({(c["kind"], c["W"]) for c in calls})
        checked, err_b = checked_fetches(calls)
        print(f"phase 10 (b) fetch (kind, W): {kinds}; the first "
              f"{KITTI_CHECKED} registration steps' fetches against their "
              f"plain versions: {sum(c['equal'] for c in checked)}/"
              f"{len(checked)} bitwise equal, max_abs_err {err_b}",
              flush=True)
        if not (len(checked) == 6 * KITTI_CHECKED
                and all(c["equal"] for c in checked)):
            raise AssertionError("phase 10 (b): a fetch kernel != its plain"
                                 " version")
        if not out["ate"] < KITTI_ATE_BOUND:
            raise AssertionError(f"phase 10 (b): ATE {out['ate']}")
        if n_gps != KITTI_GPS_FACTORS:
            raise AssertionError(f"phase 10 (b): {n_gps} GPS factors, want "
                                 f"{KITTI_GPS_FACTORS}")
        steps = np.array(out["step_ms"])
        split = {name: float(np.sum(v)) / len(steps)
                 for name, v in timer.ms.items()}
        print(f"time phase 10 (b) step: {steps.mean():.2f} ms wall a step "
              f"(steps 0-{N_KITTI - 1}; p50 {np.median(steps):.2f}, max "
              f"{steps.max():.2f}); loader (next scan from "
              f"native.ScanLoader to the card) "
              f"{np.mean(out['load_ms']):.2f} ms; per step on average "
              f"(synchronized host clock): " + ", ".join(
                  f"{name} {ms:.2f} ms" for name, ms in split.items()),
              flush=True)
        print_lm_in_turns("phase 10 (b)", timer.calls["graph"], len(steps),
                          steps.mean())

        # ---- (c) run_kitti's pair alignment on the drive's first scans:
        # the first pair's stages card against CPU, then the run ----
        clouds = [(s_.xyz[s_.valid]).numpy() for s_ in (
            kitti.load_scan(p_, 16 * 1800, n_rings=16, elev_min=-15.0,
                            elev_max=15.0, device=cpu)
            for p_ in kitti.scan_files(os.path.join(
                drive, "velodyne_points", "data"))[:2])]
        pair_card_vs_cpu(dev, clouds[1], clouds[0])
        # warm-up, not timed: one pair (the first SVD on the card loads
        # cuSOLVER)
        run_kitti.main(["--data", drive, "--scans", "2", "--device",
                        dev.type])
        pair_counts = knn_icp_counters()
        with coarse_stages(StageTimer(dev)) as stages:
            timer.sync()
            for w in pair_counts.values():
                w.launches = 0
            res = run_kitti.main(["--data", drive, "--scans",
                                  str(KITTI_PAIRS), "--device", dev.type])
            timer.sync()
            for n_, w in pair_counts.items():
                launches[f"{n_}_pairs"] = w.launches
        n_pairs = len(res["pair_ms"])
        a, kw, _ = stages.calls["ICP"][0]
        ICP_INPUTS["(b) phase 10 (c) pair"] = (a, kw)
        print(f"phase 10 (c) launches: knn {launches['knn_pairs']} (FPFH of "
              f"both clouds of {n_pairs} pairs), icp {launches['icp_pairs']}"
              f" (one a pair)", flush=True)
        if (launches["knn_pairs"], launches["icp_pairs"]) != (2 * n_pairs,
                                                               n_pairs):
            raise AssertionError(f"phase 10 (c): launches {launches}")
        still = run_kitti.chained_ate(np.zeros_like(res["traj"]),
                                      kitti.load_oxts_poses(os.path.join(
                                          drive, "oxts"))[:KITTI_PAIRS])
        print(f"phase 10 (c) pair alignment: {n_pairs} pairs of the drive's "
              f"first {KITTI_PAIRS} scans (voxel 0.3, cap 2048, FPFH k 16, "
              f"RANSAC 256 x 0.5 m, ICP 50 x 2 m): chained ATE vs oxts "
              f"{res['ate']:.4f} m (standing still {still:.4f}); steps "
              + ", ".join(
                  f"{np.linalg.norm(b - a):.3f}" for a, b in zip(
                      res["traj"][:-1], res["traj"][1:]))
              + " m (the drive moves 0.150 m a scan)", flush=True)
        print(f"time phase 10 (c) pair: {np.mean(res['pair_ms']):.2f} ms "
              f"wall a pair (p50 {np.median(res['pair_ms']):.2f}); per "
              f"pair: " + ", ".join(
                  f"{name} {sum(v) / n_pairs:.2f} ms"
                  for name, v in stages.ms.items()),
              flush=True)
        if not (res["traj"].shape == (KITTI_PAIRS, 3)
                and np.isfinite(res["traj"]).all()):
            raise AssertionError(f"phase 10 (c): trajectory {res['traj']}")
    return launches, err_b


def multisession_phase(dev):
    """Phase 10 (d): examples/run_multisession.py's configuration on the
    card.  Returns (launches {wrapper: count} over the merge, {kernel:
    max_abs_err} of its checked fetches)."""
    import tempfile
    import warnings

    import torch

    from feature_base_pointcloud_registration_tpu_torch.config import Params
    from feature_base_pointcloud_registration_tpu_torch.examples import (
        run_multisession as rms)
    from feature_base_pointcloud_registration_tpu_torch.geom.se3 import (
        apply_transform, pose6_to_matrix)
    from feature_base_pointcloud_registration_tpu_torch.io.synthetic import (
        SyntheticWorld, pose6_to_matrix_np)
    from feature_base_pointcloud_registration_tpu_torch.ops import (
        fetch as tfetch, register as tregister)
    from feature_base_pointcloud_registration_tpu_torch.ops.gn_round import (
        gn_round)
    from feature_base_pointcloud_registration_tpu_torch.ops.hashgrid import (
        grid_origin)
    from feature_base_pointcloud_registration_tpu_torch.pipeline import (
        multisession as tms)

    cpu = torch.device("cpu")
    params = Params(map_corner_cap=8192, map_surf_cap=65536)
    world = SyntheticWorld()
    t0 = time.perf_counter()
    pipes = [rms.run_session(params, world, fn, N_MS, seed0=s0, device=dev)
             for fn, s0 in ((rms.track_a, 100), (rms.track_b, 500))]
    t_sess = time.perf_counter() - t0
    sa, sb = (tms.session_from_pipeline(p) for p in pipes)
    print(f"phase 10 (d) sessions: 2 x {N_MS} SLAM steps on the card in "
          f"{t_sess:.2f} s; keyframes {sa.n} and {sb.n}", flush=True)

    # ---- the merge, counted: each link's fetches recorded ----
    counted = {"block_fetch": tfetch.block_fetch,
               "resident_fetch": tfetch.resident_fetch, "gn_round": gn_round,
               "ring_pick": ring_pick_wrapper(),
               "rounds_gn": rounds_gn_wrapper(), **pose_graph_counters(),
               **knn_icp_counters()}
    real_step = tregister.grid_register_step
    real_fetch_rows = tfetch.fetch_rows
    calls, check = [], {"on": False}
    links, timer = [], StageTimer(dev)

    def link_step(local_map, features, pose6, *, half_extent, **kw):
        check["on"] = len(links) < MS_CHECKED
        n0 = len(calls)
        before = {n_: w.launches for n_, w in counted.items()}
        # link queries within half a cell (1 m) of the grid's lower faces
        origin = grid_origin(pose6[0, 3:6], half_extent, device=dev)
        T = pose6_to_matrix(pose6[0])
        q = torch.cat([
            apply_transform(T, features.corner_xyz[0])[
                features.corner_mask[0]],
            apply_transform(T, features.surf_xyz[0])[features.surf_mask[0]]])
        near = int(((q - origin) < 1.0).any(1).sum())
        out = timer.wrap("link registration", real_step)(
            local_map, features, pose6, half_extent=half_extent, **kw)
        links.append({"launches": {n_: w.launches - before[n_]
                                   for n_, w in counted.items()},
                      "fetches": [(c["kind"], c["W"], c["rows"])
                                  for c in calls[n0:]],
                      "queries": int(q.shape[0]), "lower_face": near})
        return out

    merge_kw = dict(params=params, link_radius=8.0, link_stride=1,
                    coarse=False)
    tregister.grid_register_step = link_step
    tfetch.fetch_rows = fetch_recorder(real_fetch_rows, calls, check)
    try:
        timer.sync()
        for w in counted.values():
            w.launches = 0
        t0 = time.perf_counter()
        with icp_recorder(tms, "(c) phase 10 (d) merge"):
            res = tms.merge_sessions(None, sa, sb, device=dev, **merge_kw)
        timer.sync()
        t_merge = time.perf_counter() - t0
        launches = {n_: w.launches for n_, w in counted.items()}
    finally:
        tregister.grid_register_step = real_step
        tfetch.fetch_rows = real_fetch_rows
    print(f"phase 10 (d) merge: launches {launches}; {len(res.links)} links"
          f" of {len(links)} registrations: " + "; ".join(
              f"A[{ln.idx_a}]-B[{ln.idx_b}] {ln.correction * 100:.1f} cm"
              for ln in res.links) + f"; align fitness "
          f"{res.align_fitness:.5f}", flush=True)
    for j, lk in enumerate(links):
        print(f"phase 10 (d) link registration {j}: launches "
              f"{lk['launches']}, fetches (kind, W, rows) {lk['fetches']}, "
              f"{lk['queries']} queries, {lk['lower_face']} within half a "
              f"cell of the grid's lower faces", flush=True)
    checked, err_d = checked_fetches(calls)
    print(f"phase 10 (d) the first {MS_CHECKED} link registrations' fetches "
          f"against their plain versions: "
          f"{sum(c['equal'] for c in checked)}/{len(checked)} bitwise "
          f"equal, max_abs_err {err_d}", flush=True)
    if not (len(checked) == 6 * min(MS_CHECKED, len(links))
            and all(c["equal"] for c in checked)):
        raise AssertionError("phase 10 (d): a fetch kernel != its plain "
                             "version")
    if any(lk["launches"]["gn_round"] or lk["launches"]["rounds_gn"] != 3
           or lk["launches"]["block_fetch"]
           + lk["launches"]["resident_fetch"] != 6 for lk in links):
        raise AssertionError(f"phase 10 (d): launches {links}")
    if len(res.links) < 2:
        raise AssertionError(f"phase 10 (d): {len(res.links)} links")
    if launches["pose_graph_lm"] + launches["pose_graph_lm_b"] != 1:
        raise AssertionError(f"phase 10 (d): the joint graph's launches "
                             f"{launches}")
    if (launches["icp"], launches["knn"]) != (1, 0):
        raise AssertionError(f"phase 10 (d): the alignment's launches "
                             f"{launches} (one icp, no knn)")

    # ---- the merged map, saved, loaded, and the held-out scan ----
    with tempfile.TemporaryDirectory() as out:
        tms.save_merged_map(out, res, sa, sb)
        pose, gt_map = rms.held_out(world, out, params, device=dev)
    err = float(np.linalg.norm(pose[3:] - gt_map[3:]))
    print(f"phase 10 (d) held-out localization against the merged map: "
          f"{err:.4f} m (bound 0.06)", flush=True)
    if not err < 0.06:
        raise AssertionError(f"phase 10 (d): held-out error {err}")

    # ---- card against CPU: the same merge from the same Sessions; the
    # CPU's joint graph solved again on the card ----
    graphs, real_lm = [], tms.optimize_pose_graph

    def recorded_lm(g, **kw):
        graphs.append((g, kw))
        return real_lm(g, **kw)

    tms.optimize_pose_graph = recorded_lm
    try:
        t0 = time.perf_counter()
        res_c = tms.merge_sessions(None, sa, sb, device=cpu, **merge_kw)
        t_cpu = time.perf_counter() - t0
    finally:
        tms.optimize_pose_graph = real_lm
    g_c, kw_c = graphs[-1]
    lm_card = real_lm(type(g_c)(*(t_.to(dev) for t_ in g_c)), **kw_c)[0]
    d_lm = float((lm_card.cpu() - real_lm(g_c, **kw_c)[0]).abs().max())
    same = ([(ln.idx_a, ln.idx_b) for ln in res.links]
            == [(ln.idx_a, ln.idx_b) for ln in res_c.links])
    d_cpu = max(float(np.abs(res.poses_a - res_c.poses_a).max()),
                float(np.abs(res.poses_b - res_c.poses_b).max()))
    d_align = float(np.abs(res.transform_ab - res_c.transform_ab).max())
    d_meas = max(float(np.abs(a.meas - b.meas).max())
                 for a, b in zip(res.links, res_c.links))
    print(f"phase 10 (d) card vs CPU: the merge from the same Sessions: "
          f"same links {same}, poses |diff| max {d_cpu:.3e} (bound "
          f"{MERGE_TOL}); the alignment (ICP) |diff| {d_align:.3e}, the "
          f"links' measurements (GN) {d_meas:.3e}; the CPU's joint graph "
          f"solved on the card |diff| {d_lm:.3e} (bound 1e-5); the CPU "
          f"merge took {t_cpu:.2f} s", flush=True)
    if not (same and d_cpu <= MERGE_TOL and d_lm <= 1e-5):
        raise AssertionError(f"phase 10 (d): card vs CPU {d_cpu} {d_lm}")

    # ---- align_sessions with the coarse FPFH + RANSAC stage: the frames'
    # known offset is A's first ground-truth pose against B's.  RANSAC's
    # outcome depends on its draws, so ALIGN_DRAWS generator seeds run; the
    # first is timed stage by stage ----
    true_ab = (np.linalg.inv(pose6_to_matrix_np(rms.track_a(0)))
               @ pose6_to_matrix_np(rms.track_b(0)))
    gen = torch.Generator(device=dev)

    def align(seed, coarse=True):
        gen.manual_seed(seed)
        return tms.align_sessions(gen, sa, sb, coarse=coarse, device=dev)

    def offset_error(ar):
        e = ar.transform @ np.linalg.inv(true_ab) - np.eye(4)
        return float(np.abs(e[:3, 3]).max()), float(np.abs(e[:3, :3]).max())

    with coarse_stages(StageTimer(dev)) as stages:
        timer.sync()
        t0 = time.perf_counter()
        draws = [align(0)]
        timer.sync()
        t_align = (time.perf_counter() - t0) * 1e3
    draws += [align(s) for s in range(1, ALIGN_DRAWS)]
    errs = [offset_error(ar) for ar in draws]
    fine = offset_error(align(0, coarse=False))
    hits = sum(e_t < ALIGN_BOUND[0] and e_r < ALIGN_BOUND[1]
               for e_t, e_r in errs)
    print(f"phase 10 (d) align_sessions(coarse=True, leaf 0.4, cap 4096, "
          f"512 hypotheses at 0.5 m), seeds 0-{ALIGN_DRAWS - 1}: offset "
          f"error (m, rotation) and fitness " + "; ".join(
              f"{e_t:.4f} {e_r:.4f} {ar.fitness:.4f}"
              for (e_t, e_r), ar in zip(errs, draws))
          + f"; {hits} within {ALIGN_BOUND}; within 0.05 m and 0.02 "
          f"(tests/test_multisession.py's bounds on its own sessions) "
          f"{sum(e_t < 0.05 and e_r < 0.02 for e_t, e_r in errs)}; "
          f"coarse=False (ICP alone) {fine[0]:.4f} {fine[1]:.4f}",
          flush=True)
    print(f"time phase 10 (d): align_sessions {t_align:.2f} ms wall (" +
          ", ".join(f"{name} {sum(v):.2f} ms" for name, v in
                    stages.ms.items()) + f"); merge (coarse=False) "
          f"{t_merge * 1e3:.2f} ms wall, link registrations " +
          ", ".join(f"{v:.2f}" for v in timer.ms["link registration"])
          + " ms", flush=True)
    if not (hits >= 1 and fine[0] < ALIGN_BOUND[0]
            and fine[1] < ALIGN_BOUND[1]):
        raise AssertionError(f"phase 10 (d): coarse alignment {errs}, "
                             f"ICP alone {fine}")
    wall_p, busy, top = profile_call(lambda: align(0))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        if dev.type == "cuda":
            torch.cuda.set_sync_debug_mode("warn")
        try:
            align(0)
        finally:
            if dev.type == "cuda":
                torch.cuda.set_sync_debug_mode("default")
    syncs = sum("synchroniz" in str(w_.message) for w_ in caught)
    print(f"profile phase 10 (d) align_sessions (torch.profiler): wall "
          f"{wall_p:.2f} ms, device busy {busy:.2f} ms "
          f"({busy / wall_p:.1%}), host syncs {syncs} (sync debug mode); by "
          f"device time: " + "; ".join(f"{name[:50]} {ms:.3f}"
                                       for name, ms in top[:5]), flush=True)
    return launches, err_d

def sharded_phase(dev, bench):
    """Phase 11: the sharded solvers on torch.distributed and the XLA solver
    variants, on the card at the bench's width (bench: phase 3's features,
    guesses, map, tables and helpers from main).  Returns (launches
    {wrapper: count} of (a) and (b), {kernel: max_abs_err} of (a)-(c))."""
    import tempfile

    import torch
    import torch.distributed as dist

    from feature_base_pointcloud_registration_tpu_torch.ops.fetch import (
        block_fetch, block_fetch_reference)
    from feature_base_pointcloud_registration_tpu_torch.ops.hashgrid import (
        build_grid_packed, default_grid_spec, grid_origin,
        grid_overflow_fraction)
    from feature_base_pointcloud_registration_tpu_torch.parallel import (
        batch as pbatch, dryrun, map_sharded as pms)

    f, g, fmap = bench.feats, bench.guesses, bench.fmap
    ctab, stab, origin, dims = bench.tabs
    kw = dict(grid_dims=dims, iters_per_round=ITERS, num_candidates=K,
              round1_surf_stride=R1S, round1_corner_stride=R1C)
    caps = dict(corner_cell_cap=CCAP, surf_cell_cap=SCAP)
    rounds = dict(num_rounds=2, iters_per_round=ITERS, num_candidates=K)
    launches = {"block_fetch": 0, "resident_fetch": 0, "gn_round": 0,
                "ring_pick": 0, "rounds_gn": 0}
    err = {}

    def same(a, b):
        """(bitwise equal, max |pose diff|) of two RegisterResults."""
        return (all(torch.equal(x, y) for x, y in zip(a, b)),
                float((a.pose6 - b.pose6).abs().max()))

    def count(phase, want):
        got = bench.read_counts(phase, want)
        for k, v in got.items():
            launches[k] += v

    t0 = time.perf_counter()
    torch.cuda.set_device(dev)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", store=dist.FileStore(
            os.path.join(tmp, "store"), 1), rank=0, world_size=1)
        try:
            # (a) the fused solver data-parallel on a one-rank NCCL mesh
            mesh = pbatch.make_mesh("cuda")
            for name, (ct, st), want in (
                    ("raw", (ctab, stab), {"block_fetch": 4,
                                           "resident_fetch": 0,
                                           "gn_round": 2, "ring_pick": 0,
                                           "rounds_gn": 0}),
                    ("resident", bench.rtabs[:2], {"block_fetch": 0,
                                                   "resident_fetch": 4,
                                                   "gn_round": 2,
                                                   "ring_pick": 0,
                                                   "rounds_gn": 0})):
                ref = pbatch.batch_register_fused(f, ct, st, origin, g, **kw)
                bench.zero_counts()
                res, stats = pbatch.shard_register_tables(
                    mesh, f, ct, st, origin, g, solver="fused", **caps, **kw)
                count(f"11 (a) {name}", want)
                eq, d = same(res, ref)
                print(f"phase 11 (a) shard_register_tables(solver='fused') "
                      f"{name} tables on a one-rank NCCL mesh: bitwise "
                      f"{eq} (pose |diff| {d}) vs batch_register_fused; "
                      f"n_total {int(stats['n_total'])} n_converged "
                      f"{int(stats['n_converged'])} mean iterations "
                      f"{float(stats['mean_iterations']):.3f}", flush=True)
                if not eq or int(stats["n_total"]) != B:
                    raise AssertionError(f"phase 11 (a) {name}: {d}, "
                                         f"n_total {stats['n_total']}")
                kern = "block_fetch" if name == "raw" else "resident_fetch"
                err[kern] = max(err.get(kern, 0.0), d)
                err["gn_round"] = max(err.get("gn_round", 0.0), d)
            t_sh = cuda_ms(lambda: pbatch.shard_register_tables(
                mesh, f, ctab, stab, origin, g, solver="fused", **caps,
                **kw), 3)
            t_un = cuda_ms(lambda: pbatch.batch_register_fused(
                f, ctab, stab, origin, g, **kw), 3)
            print(f"time phase 11 (a): shard_register_tables {t_sh / B:.4f} "
                  f"ms/scan, batch_register_fused {t_un / B:.4f} ms/scan "
                  f"({bench.gpu})", flush=True)

            # (b) the map-sharded tables on a one-rank ("data", "map") mesh
            mesh2 = pms.make_2d_mesh("cuda", 1, data=1)
            cts, sts, o1, d1 = pms.build_sharded_block_tables(
                fmap, bench.center, bench.half, 1, **caps)
            one = torch.equal(cts[0], ctab) and torch.equal(sts[0], stab)
            ref = pbatch.batch_register_pallas(f, ctab, stab, origin, g,
                                               grid_dims=dims, **caps,
                                               **rounds)
            bench.zero_counts()
            res, stats = pms.map_sharded_register_tables(
                mesh2, f, cts, sts, o1, g, grid_dims=d1, **caps, **rounds)
            count("11 (b)", {"block_fetch": 4, "resident_fetch": 0,
                             "gn_round": 0, "ring_pick": 0, "rounds_gn": 2})
            eq, d = same(res, ref)
            print(f"phase 11 (b) map_sharded_register_tables, S=1: tables "
                  f"= build_map_planar_tables' {one}; bitwise {eq} (pose "
                  f"|diff| {d}) vs batch_register_pallas on those tables; "
                  f"n_converged {int(stats['n_converged'])}", flush=True)
            if not (one and eq):
                raise AssertionError(f"phase 11 (b): tables {one}, {d}")
            err["block_fetch"] = max(err["block_fetch"], d)
        finally:
            dist.destroy_process_group()

    # (c) four striped shards' fetches in this process, merged
    cts, sts, _, _ = pms.build_sharded_block_tables(
        fmap, bench.center, bench.half, 4, **caps)
    q = bench.queries_surf
    parts = [block_fetch(t, *q, K=K, planes_out=False) for t in sts]
    merged = pms.merge_topk(torch.stack([p[0] for p in parts]),
                            torch.stack([p[1] for p in parts]), K)
    torch.cuda.synchronize()
    plain = []
    for t in sts:
        d2, cand = block_fetch_reference(t, *q, K=K)
        plain.append((d2, cand.view(3, K, -1).permute(2, 1, 0)))
    pmerged = pms.merge_topk(torch.stack([p[0] for p in plain]),
                             torch.stack([p[1] for p in plain]), K)
    eq = all(torch.equal(a, b) for a, b in zip(merged, pmerged))
    d_c = max(float((a - b).abs().max()) for a, b in zip(merged, pmerged))
    full = block_fetch_reference(stab, *q, K=K)[0]
    live = q[0] != stab.shape[0] - 1
    print(f"phase 11 (c) 4 striped surf shards (W "
          f"{sts.shape[2] // 3}), {int(live.sum())} live round-1 queries: "
          f"merged kernel fetch bitwise {eq} (max_abs_err {d_c}) vs the "
          f"plain fetches' merge; d2 equal to the replicated table's on "
          f"{float((merged[0] == full).all(1)[live].float().mean()):.4f} of "
          f"live queries", flush=True)
    if not eq:
        raise AssertionError(f"phase 11 (c): merged fetch {d_c}")
    err["block_fetch"] = max(err["block_fetch"], d_c)

    # (d) the XLA solver variants (plain PyTorch on the card)
    sent = pbatch.build_map_grids(fmap, bench.center, bench.half, **caps)
    dims1 = default_grid_spec(bench.half, 1.0)
    org1 = grid_origin(bench.center, bench.half, device=dev)
    packed = [build_grid_packed(x, m, org1, 1.0, dims=dims1,
                                cell_cap=FAST_GRID_CAP)
              for x, m in ((fmap.corner_xyz, fmap.corner_mask),
                           (fmap.surf_xyz, fmap.surf_mask))]
    ovf = [float(grid_overflow_fraction(x, m, org1, 1.0, dims=dims1,
                                        cell_cap=FAST_GRID_CAP))
           for x, m in ((fmap.corner_xyz, fmap.corner_mask),
                        (fmap.surf_xyz, fmap.surf_mask))]
    sub = type(f)(*(a[:N_FAST] for a in f))
    solvers = {
        "batch_register_rounds": (lambda: pbatch.batch_register_rounds(
            f, sent[0], sent[1], sent[2], g, grid_dims=sent[3], **caps,
            **rounds), B, PARITY_BUDGET),
        "batch_register_fast_grid": (lambda: pbatch.batch_register_fast_grid(
            f, fmap, packed[0], packed[1], org1, g, grid_dims=dims1,
            cell_size=1.0, cell_cap=FAST_GRID_CAP), B, FAST_BUDGET),
        "batch_register_fast": (lambda: pbatch.batch_register_fast(
            sub, fmap, g[:N_FAST], chunk=FAST_CHUNK), N_FAST, FAST_BUDGET),
    }
    print(f"phase 11 (d) packed 1 m tables cap {FAST_GRID_CAP}: dims "
          f"{dims1}, grid_overflow {ovf}", flush=True)
    for name, (fn, n, budget) in solvers.items():
        bench.zero_counts()
        torch.cuda.reset_peak_memory_stats(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        res = fn()
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end)
        count(f"11 (d) {name}", {
            "block_fetch": 0, "resident_fetch": 0, "gn_round": 0,
            "ring_pick": 0,
            "rounds_gn": 2 if name == "batch_register_rounds" else 0})
        if name == "batch_register_rounds":
            ms_k = cuda_ms(fn, 2)
            with plain_rounds():
                ms_p = cuda_ms(fn, 1)
            print(f"time phase 11 (d) {name}: {ms_k / n:.4f} ms/scan with "
                  f"the rounds on the rounds_gn kernel, {ms_p / n:.4f} "
                  f"ms/scan on the parent's loop (rounds_gn_reference)",
                  flush=True)
        pose = res.pose6.cpu().numpy()
        if not (np.isfinite(pose).all() and pose.shape == (n, 6)):
            raise AssertionError(f"phase 11 (d) {name}: poses")
        ate = bench.ate_oracle_of(pose)
        n_or = min(len(bench.oracle_poses), n)
        lane_err = np.linalg.norm(pose[:n_or, 3:]
                                  - bench.oracle_poses[:n_or, 3:], axis=1)
        print(f"phase 11 (d) {name}: translation error against the oracle "
              f"on scans 0-{n_or - 1} {np.round(lane_err, 6).tolist()}, "
              f"iterations {res.iterations[:n_or].tolist()}", flush=True)
        d6 = float(np.abs(pose - bench.pose6[:n]).max())
        print(f"phase 11 (d) {name} B={n}: ate_vs_oracle_m {ate} (gate "
              f"{budget}); pose |diff| vs phase 6 batch_register_pallas max "
              f"{d6}; n_converged {int(res.converged.sum())}/{n} mean "
              f"iterations {res.iterations.float().mean().item():.2f}; "
              f"time {ms / n:.4f} ms/scan ({ms:.1f} ms, first call, "
              f"{bench.gpu}); peak memory "
              f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB",
              flush=True)
        if not ate <= budget:
            raise AssertionError(f"phase 11 (d) {name}: ate_vs_oracle_m "
                                 f"{ate} > {budget}")
        if name == "batch_register_fast_grid":
            cpu = torch.device("cpu")
            lanes = slice(0, n_or)
            res_c = pbatch.batch_register_fast_grid(
                type(f)(*(a[lanes].cpu() for a in f)),
                type(fmap)(*(a.cpu() for a in fmap)), packed[0].cpu(),
                packed[1].cpu(), org1.cpu(), g[lanes].cpu(), grid_dims=dims1,
                cell_size=1.0, cell_cap=FAST_GRID_CAP)
            d = np.abs(pose[lanes] - res_c.pose6.numpy()).max(1)
            print(f"phase 11 (d) {name}: the same {n_or} scans on the CPU: "
                  f"ate_vs_oracle_m {bench.ate_oracle_of(res_c.pose6.numpy())}"
                  f", card vs CPU pose |diff| per scan "
                  f"{[float(f'{x:.3e}') for x in d]}, iterations "
                  f"{res_c.iterations.tolist()}", flush=True)

    # (e) the dry run's spawned NCCL rank (one card): every stage
    t1 = time.perf_counter()
    out = dryrun.dryrun_multichip(1, backend="nccl")[0]
    for name, (res, stats) in out.items():
        if not np.isfinite(res.pose6).all():
            raise AssertionError(f"phase 11 (e) {name}: poses")
    print(f"phase 11 (e) dryrun_multichip(1, backend='nccl'): stages "
          f"{sorted(out)} in {time.perf_counter() - t1:.1f} s", flush=True)
    print(f"phase 11: {time.perf_counter() - t0:.1f} s", flush=True)
    return launches, err


def main():
    import torch

    from feature_base_pointcloud_registration_tpu_torch import kernels
    from feature_base_pointcloud_registration_tpu_torch.config import Params
    from feature_base_pointcloud_registration_tpu_torch.device import (
        require_cuda)
    from feature_base_pointcloud_registration_tpu_torch.io.synthetic import (
        SyntheticWorld, build_feature_map, simulate_scan)
    from feature_base_pointcloud_registration_tpu_torch.ops.features import (
        extract_features, ring_pick)
    from feature_base_pointcloud_registration_tpu_torch.ops.fetch import (
        PlanarTable, block_fetch, block_fetch_reference, resident_fetch,
        resident_fetch_reference)
    from feature_base_pointcloud_registration_tpu_torch.ops.gn_round import (
        gn_round, gn_round_reference)
    from feature_base_pointcloud_registration_tpu_torch.ops.hashgrid import (
        grid_overflow_fraction)
    from feature_base_pointcloud_registration_tpu_torch.ops.projection import (
        project_scan)
    from feature_base_pointcloud_registration_tpu_torch.parallel import (
        batch as pbatch)
    from feature_base_pointcloud_registration_tpu_torch.parallel.batch import (
        batch_register_blocks, batch_register_fused, batch_register_pallas,
        build_map_block_tables, build_map_planar_tables, feature_planes,
        fetch_queries, initial_state, presort_by_row)
    from feature_base_pointcloud_registration_tpu_torch.pipeline.cloud_info import (  # noqa: E501
        FeatureMap, RawScan)
    from feature_base_pointcloud_registration_tpu_torch.pipeline.frontend import (  # noqa: E501
        downsample_features)

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--gn-ab", action="append", default=[],
                    metavar="NAME=PATH", type=lambda v: v.split("=", 1),
                    help="another gn_round.cu to time beside the shipped one")
    ap.add_argument("--lm-ab", metavar="DIR",
                    help="a directory holding another version of "
                         "pose_graph_lm.cu and imu_chain_lm.cu (and the "
                         "headers they include) to time in turns with the "
                         "shipped ones at the LM probes and phases 8-9")
    ap.add_argument("--knn-icp-ab", metavar="DIR",
                    help="a directory holding another version of "
                         "knn_stream.cu and icp.cu (and the headers they "
                         "include) to run in turns with the shipped ones, "
                         "bit for bit, at the knn and ICP probes, the GPU "
                         "tests' scenes and phase 8's ICP runs")
    ap.add_argument("--imu-ab", metavar="DIR",
                    help="a directory holding another version of "
                         "preintegration.cu (and the headers it includes) "
                         "to run in turns with the shipped one, bit for "
                         "bit, at the preintegrate and propagate_states "
                         "probes, the GPU tests' buffers and phase 9's "
                         "calls")
    args = ap.parse_args()
    dev = require_cuda()
    sys.path.insert(0, os.path.join(REPO, "tests"))    # oracle.py
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"gpu: {smi}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)

    t0 = time.perf_counter()
    kernels.library()
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    for log in sorted(glob.glob(os.path.join(kernels.BUILD_DIR,
                                             "libfbpr_*.log"))):
        print_ptxas(os.path.basename(log).split("-")[0][len("libfbpr_"):],
                    log)
    variants = gn_variants(args.gn_ab)
    if args.lm_ab:
        LM_AB.update(plain=lm_builds(args.lm_ab, profile=False),
                     profile=lm_builds(args.lm_ab))
    if args.knn_icp_ab:
        KI_AB.update(plain=ab_builds(("knn_stream", "icp"), args.knn_icp_ab),
                     profile=ab_builds(("icp",), args.knn_icp_ab,
                                       "-DFBPR_ICP_PROFILE"))
    if args.imu_ab:
        IMU_AB.update(plain=ab_builds(("preintegration",),
                                      args.imu_ab)["preintegration"])

    # ---- setup: bench.py's scans, guesses and map, from seeds ----
    params = Params(map_corner_cap=16384, map_surf_cap=65536,
                    strict_feature_pick=False)
    world = SyntheticWorld()
    rng = np.random.RandomState(0)
    raws, gt = [], []
    for i in range(B):
        pose = np.array([0, 0, rng.uniform(-1, 1), rng.uniform(-6, 6),
                         rng.uniform(-6, 6), 0.0], np.float32)
        s = simulate_scan(world, pose, seed=i)
        raws.append((s["xyz"], s["intensity"], s["ring"], s["time"],
                     s["valid"]))
        gt.append(pose)
    raw = RawScan(*(torch.from_numpy(np.stack(a)).to(dev)
                    for a in zip(*raws)))
    gt = np.stack(gt)
    guesses = gt + rng.uniform(-1, 1, (B, 6)).astype(np.float32) * np.array(
        [0.02, 0.02, 0.05, 0.3, 0.3, 0.1], np.float32)
    guesses_t = torch.from_numpy(guesses).to(dev)
    mcx, mcm, msx, msm = build_feature_map(world, params.map_corner_cap,
                                           params.map_surf_cap)
    fmap = FeatureMap(*(torch.from_numpy(a).to(dev)
                        for a in (mcx, mcm, msx, msm)))
    center = np.array([0.0, 0.0, (world.ground_z + world.ceil_z) / 2],
                      np.float32)
    half = np.array([world.half_x + 1, world.half_y + 1,
                     (world.ceil_z - world.ground_z) / 2 + 1], np.float32)

    def frontend(r):
        return downsample_features(
            params, extract_features(params, project_scan(params, r),
                                     strict=False))

    def tables(resident=False):
        return build_map_planar_tables(fmap, center, half,
                                       corner_cell_cap=CCAP,
                                       surf_cell_cap=SCAP, resident=resident)

    def solve(feats, tabs):
        ctab, stab, origin, dims = tabs
        return batch_register_fused(
            feats, ctab, stab, origin, guesses_t, grid_dims=dims,
            iters_per_round=ITERS, num_candidates=K,
            round1_surf_stride=R1S, round1_corner_stride=R1C)

    feats = frontend(raw)
    ctab, stab, origin, dims = tabs = tables()
    n_corner = feats.corner_mask.sum(1).float().mean().item()
    n_surf = feats.surf_mask.sum(1).float().mean().item()
    print(f"setup: B={B} corner/scan {n_corner:.0f} surf/scan {n_surf:.0f} "
          f"tables corner {tuple(ctab.shape)} surf {tuple(stab.shape)} "
          f"dims {dims}", flush=True)

    # ---- the main path's round 0 (its inputs kept for phase 2 and the
    # timing), to reach its round-1 queries ----
    stat, matP = initial_state(feats, guesses_t)
    fc = feature_planes(feats.corner_xyz, feats.corner_mask)
    fs = feature_planes(feats.surf_xyz, feats.surf_mask)
    q0c = fetch_queries(stat[:, :6], feats.corner_xyz[:, ::R1C],
                        feats.corner_mask[:, ::R1C], ctab, origin, 2.0, dims)
    q0s = fetch_queries(stat[:, :6], feats.surf_xyz[:, ::R1S],
                        feats.surf_mask[:, ::R1S], stab, origin, 2.0, dims)
    gn_args0 = (stat, matP, fc[:, :, ::R1C].contiguous(),
                fs[:, :, ::R1S].contiguous(), block_fetch(ctab, *q0c, K=K)[1],
                block_fetch(stab, *q0s, K=K)[1])
    stat, matP = gn_round(*gn_args0, K=K, iters=ITERS)
    stat[:, 7] = 0.0
    queries = {
        "corner": (ctab, fetch_queries(stat[:, :6], feats.corner_xyz,
                                       feats.corner_mask, ctab, origin, 2.0,
                                       dims)),
        "surf": (stab, fetch_queries(stat[:, :6], feats.surf_xyz,
                                     feats.surf_mask, stab, origin, 2.0,
                                     dims)),
    }

    # ---- phase 1: fetch kernel vs plain version, bitwise ----
    cands, raw_d2, fetch_err = {}, {}, 0.0
    for kind, (tab, q) in queries.items():
        d2k, ck = block_fetch(tab, *q, K=K)
        torch.cuda.synchronize()
        d2r, cr = block_fetch_reference(tab, *q, K=K)
        live = (q[0] != tab.shape[0] - 1).float().mean().item()
        err = max((d2k - d2r).abs().max().item(),
                  (ck - cr).abs().max().item())
        print(f"phase 1 fetch {kind}: Q={q[0].shape[0]} W={tab.shape[1] // 3}"
              f" live {live:.3f} d2 equal {torch.equal(d2k, d2r)} cand equal"
              f" {torch.equal(ck, cr)} max_abs_err {err}", flush=True)
        if not (torch.equal(d2k, d2r) and torch.equal(ck, cr)):
            raise AssertionError(f"fetch kernel != plain version ({kind})")
        cands[kind] = ck
        raw_d2[kind] = d2k
        fetch_err = max(fetch_err, err)

    # ---- phase 2: GN kernel vs plain version on both rounds' inputs ----
    gn_args = (stat, matP, fc, fs, cands["corner"], cands["surf"])
    gn_rounds = (gn_args0, gn_args)
    gn_out, gn_plain, gn_err = [], [], 0.0
    for r, a in enumerate(gn_rounds):
        sk, mk = gn_round(*a, K=K, iters=ITERS)
        torch.cuda.synchronize()
        sr, mr = gn_round_reference(*a, K=K, iters=ITERS)
        dpose = (sk[:, :6] - sr[:, :6]).abs()
        err = dpose.max().item()
        first = int(((a[0][:, 6] == 0) & (a[0][:, 9] > 0)).sum())
        its_eq = (sk[:, 6] == sr[:, 6]).float().mean().item()
        ncorr_eq = (sk[:, 10] == sr[:, 10]).float().mean().item()
        print(f"phase 2 gn round {r}: Pc={a[2].shape[2]} Ps={a[3].shape[2]}"
              f" lanes at iteration 0 (Jacobi) {first}; pose |diff| max "
              f"{err:.3e} median {dpose.max(1).values.median().item():.3e};"
              f" iterations equal {its_eq:.3f}; n_corr equal {ncorr_eq:.3f};"
              f" matP |diff| max {(mk - mr).abs().max().item():.3e}",
              flush=True)
        if not err <= 1e-3:
            raise AssertionError(f"GN kernel vs plain version, round {r}: "
                                 f"{err} > 1e-3")
        if not min(its_eq, ncorr_eq) >= GN_EQUAL_LANES:
            raise AssertionError(
                f"GN kernel vs plain version, round {r}: iterations equal on"
                f" {its_eq:.3f}, n_corr on {ncorr_eq:.3f} of lanes (want >= "
                f"{GN_EQUAL_LANES})")
        gn_out.append(sk)
        gn_plain.append(sr)
        gn_err = max(gn_err, err)
    for name, call in variants.items():
        errs = [(call(a, ITERS)[0][:, :6] - sr[:, :6]).abs().max().item()
                for a, sr in zip(gn_rounds, gn_plain)]
        print(f"phase 2 gn {name}: pose |diff| max vs plain version "
              f"round 0 {errs[0]:.3e} round 1 {errs[1]:.3e}", flush=True)

    # ---- phase 3: the slice end to end, counted ----
    wrappers = {"block_fetch": block_fetch, "resident_fetch": resident_fetch,
                "gn_round": gn_round, "ring_pick": ring_pick,
                "rounds_gn": rounds_gn_wrapper()}

    def zero_counts():
        torch.cuda.synchronize()
        for w in wrappers.values():
            w.launches = 0

    def read_counts(phase, want):
        torch.cuda.synchronize()
        got = {name: w.launches for name, w in wrappers.items()}
        print(f"phase {phase} launches: {got}", flush=True)
        if got != want:
            raise AssertionError(f"phase {phase} launches {got}, want {want}")
        return got

    per_round = []

    def counted_gn(*a, **kw):           # GN launches of each round
        before = gn_round.launches
        out = gn_round(*a, **kw)
        per_round.append(gn_round.launches - before)
        return out

    zero_counts()
    feats3 = frontend(raw)
    pbatch.gn_round = counted_gn
    try:
        res = solve(feats3, tables())
    finally:
        pbatch.gn_round = gn_round
    launches = read_counts(3, {"block_fetch": 4, "resident_fetch": 0,
                               "gn_round": 2, "ring_pick": 1,
                               "rounds_gn": 0})
    print(f"phase 3 gn launches per round: {per_round}", flush=True)
    if per_round != [1, 1]:
        raise AssertionError(f"GN launches per round {per_round}")

    pose = res.pose6.cpu().numpy()
    if not (np.isfinite(pose).all() and pose.shape == (B, 6)):
        raise AssertionError("non-finite or misshapen poses")
    err_t = np.linalg.norm(pose[:, 3:] - gt[:, 3:], axis=1)
    ate_gt = float(np.sqrt((err_t ** 2).mean()))
    import oracle
    fe = [a.cpu().numpy() for a in feats3]
    mc, ms = mcx[mcm], msx[msm]
    n_or = min(N_ORACLE, B)
    oracle_poses = np.stack([
        oracle.register_scan(fe[0][i][fe[1][i]], fe[2][i][fe[3][i]], mc, ms,
                             guesses[i])[0] for i in range(n_or)])
    d = pose[:n_or, 3:] - oracle_poses[:, 3:]
    ate_oracle = float(np.sqrt((d ** 2).sum(-1).mean()))
    ovf = [float(grid_overflow_fraction(xyz, m, origin, 2.0, dims=dims,
                                        cell_cap=cap))
           for xyz, m, cap in ((fmap.corner_xyz, fmap.corner_mask, CCAP),
                               (fmap.surf_xyz, fmap.surf_mask, SCAP))]
    n_conv = int(res.converged.sum())
    print(f"phase 3: n_converged {n_conv}/{B} valid {int(res.valid.sum())} "
          f"degenerate {int(res.is_degenerate.sum())} mean iterations "
          f"{res.iterations.float().mean().item():.2f} ate_vs_gt_m {ate_gt} "
          f"ate_vs_oracle_m {ate_oracle} grid_overflow {ovf}", flush=True)
    if not ate_oracle <= PARITY_BUDGET:
        raise AssertionError(f"ate_vs_oracle_m {ate_oracle} > "
                             f"{PARITY_BUDGET}")

    def ate_oracle_of(poses):
        d = poses[:n_or, 3:] - oracle_poses[:, 3:]
        return float(np.sqrt((d ** 2).sum(-1).mean()))

    # ---- phase 4: resident fetch kernel vs plain version, bitwise ----
    rtabs = tables(resident=True)
    if not all(isinstance(t, PlanarTable) for t in rtabs[:2]):
        raise AssertionError("resident=True did not compact both tables")
    rqueries, res_err = {}, 0.0
    for kind, rtab in (("corner", rtabs[0]), ("surf", rtabs[1])):
        tab, q = queries[kind]
        rows = rtab.rows_index[q[0].long()]
        rq = rqueries[kind] = (rtab.table, (rows, *q[1:]))
        d2k, ck = resident_fetch(rq[0], *rq[1], K=K)
        torch.cuda.synchronize()
        d2r, cr = resident_fetch_reference(rq[0], *rq[1], K=K)
        err = max((d2k - d2r).abs().max().item(),
                  (ck - cr).abs().max().item())
        res_err = max(res_err, err)
        Rp = rtab.table.shape[0] - 1
        found = rows != Rp
        print(f"phase 4 resident {kind}: Q={rows.shape[0]} "
              f"W={rtab.table.shape[1] // 3} live {found.float().mean().item():.3f}"
              f" compact rows {Rp} ({rtab.table.numel() * 4} B) raw rows "
              f"{tab.shape[0] - 1} ({tab.numel() * 4} B); d2 equal "
              f"{torch.equal(d2k, d2r)} cand equal {torch.equal(ck, cr)} "
              f"max_abs_err {err}; vs raw fetch: d2 equal "
              f"{torch.equal(d2k, raw_d2[kind])}, cand equal where found "
              f"{torch.equal(ck[:, found], cands[kind][:, found])}",
              flush=True)
        if not (torch.equal(d2k, d2r) and torch.equal(ck, cr)):
            raise AssertionError(f"resident kernel != plain version ({kind})")
        if not (torch.equal(d2k, raw_d2[kind])
                and torch.equal(ck[:, found], cands[kind][:, found])):
            raise AssertionError(f"resident fetch != raw fetch ({kind})")

    # ---- phase 5: the main path on resident tables, counted ----
    zero_counts()
    feats5 = frontend(raw)
    res5 = solve(feats5, tables(resident=True))
    launches5 = read_counts(5, {"block_fetch": 0, "resident_fetch": 4,
                                "gn_round": 2, "ring_pick": 1,
                                "rounds_gn": 0})
    pose5 = res5.pose6.cpu().numpy()
    d5 = float(np.abs(pose5 - pose).max())
    ate5 = ate_oracle_of(pose5)
    print(f"phase 5: pose |diff| vs phase 3 max {d5}; n_converged "
          f"{int(res5.converged.sum())}/{B} ate_vs_oracle_m {ate5}; features"
          f" bitwise phase 3's {all(map(torch.equal, feats5, feats3))}",
          flush=True)
    if not (np.isfinite(pose5).all() and d5 <= 1e-6):
        raise AssertionError(f"resident main path moved poses by {d5}")
    if not ate5 <= PARITY_BUDGET:
        raise AssertionError(f"phase 5 ate_vs_oracle_m {ate5}")

    # ---- phase 6: the rounds-structured solver, counted ----
    def solve_rounds(feats, tabs_, n=B):
        ctab_, stab_, origin_, dims_ = tabs_
        return batch_register_pallas(
            feats, ctab_, stab_, origin_, guesses_t[:n], grid_dims=dims_,
            corner_cell_cap=CCAP, surf_cell_cap=SCAP, num_rounds=2,
            iters_per_round=ITERS, num_candidates=K)

    zero_counts()
    unrecord = record_rounds("phase 6", n=2)
    try:
        res6 = solve_rounds(frontend(raw), rtabs)
    finally:
        unrecord()
    launches6 = read_counts(6, {"block_fetch": 0, "resident_fetch": 4,
                                "gn_round": 0, "ring_pick": 1,
                                "rounds_gn": 2})
    pose6 = res6.pose6.cpu().numpy()
    err6 = np.linalg.norm(pose6[:, 3:] - gt[:, 3:], axis=1)
    ate6_gt = float(np.sqrt((err6 ** 2).mean()))
    ate6 = ate_oracle_of(pose6)
    btabs = build_map_block_tables(fmap, center, half, corner_cell_cap=CCAP,
                                   surf_cell_cap=SCAP)
    sub = type(feats3)(*(a[:N_BLOCKS] for a in feats3))
    res_b = batch_register_blocks(
        sub, btabs[0], btabs[1], btabs[2], guesses_t[:N_BLOCKS],
        grid_dims=btabs[3], corner_cell_cap=CCAP, surf_cell_cap=SCAP,
        num_rounds=2, iters_per_round=ITERS, num_candidates=K)
    d6 = float(np.abs(res_b.pose6.cpu().numpy() - pose6[:N_BLOCKS]).max())
    print(f"phase 6: n_converged {int(res6.converged.sum())}/{B} degenerate "
          f"{int(res6.is_degenerate.sum())} mean iterations "
          f"{res6.iterations.float().mean().item():.2f} ate_vs_gt_m {ate6_gt}"
          f" ate_vs_oracle_m {ate6}; batch_register_blocks on {N_BLOCKS} "
          f"scans: pose |diff| max {d6}", flush=True)
    if not (np.isfinite(pose6).all() and ate6 <= PARITY_BUDGET):
        raise AssertionError(f"phase 6 ate_vs_oracle_m {ate6}")
    if not d6 <= 1e-4:
        raise AssertionError(f"batch_register_blocks vs pallas: {d6}")

    # ---- timing (CUDA events; not counted as main-path launches) ----
    def fetch_times(fn, plain, tab_q):
        return (cuda_ms(lambda: fn(tab_q[0], *tab_q[1], K=K), 20),
                cuda_ms(lambda: plain(tab_q[0], *tab_q[1], K=K), 2))

    kt = {
        "fetch_surf": fetch_times(block_fetch, block_fetch_reference,
                                  queries["surf"]),
        "fetch_corner": fetch_times(block_fetch, block_fetch_reference,
                                    queries["corner"]),
        "resident_surf": fetch_times(resident_fetch, resident_fetch_reference,
                                     rqueries["surf"]),
        "resident_corner": fetch_times(resident_fetch,
                                       resident_fetch_reference,
                                       rqueries["corner"]),
        "gn_round": (cuda_ms(lambda: gn_round(*gn_args, K=K, iters=ITERS),
                             10, graph=True),
                     cuda_ms(lambda: gn_round_reference(*gn_args, K=K,
                                                        iters=ITERS), 2)),
        "gn_round0": (cuda_ms(lambda: gn_round(*gn_args0, K=K,
                                               iters=ITERS), 10, graph=True),
                      cuda_ms(lambda: gn_round_reference(*gn_args0, K=K,
                                                         iters=ITERS), 2)),
    }
    bounds = {name: fetch_bound(tq[0], tq[1][0], K) for name, tq in (
        ("fetch_surf", queries["surf"]), ("fetch_corner", queries["corner"]),
        ("resident_surf", rqueries["surf"]),
        ("resident_corner", rqueries["corner"]))}
    floors = {}
    for name, a, out in (("gn_round0", gn_args0, gn_out[0]),
                         ("gn_round", gn_args, gn_out[1])):
        *bounds[name], floors[name] = gn_bound(a, out, K)
    for name, (ms_k, ms_p) in kt.items():
        floor = (f", streamed floor {floors[name]:.4f} ms"
                 if name in floors else "")
        print(f"time {name}: kernel {ms_k:.3f} ms, plain {ms_p:.3f} ms, "
              f"bound {bounds[name][0]:.4f} ms ({bounds[name][1]}){floor}",
              flush=True)
    for vname, call in variants.items():
        print(f"time gn_round0 {vname}: "
              f"{cuda_ms(lambda: call(gn_args0, ITERS), 10, True):.3f} ms; "
              f"gn_round {vname}: "
              f"{cuda_ms(lambda: call(gn_args, ITERS), 10, True):.3f} ms",
              flush=True)
    t_front = cuda_ms(lambda: frontend(raw), 3)
    with plain_picking():
        t_front_plain = cuda_ms(lambda: frontend(raw), 2)
    t_tables = cuda_ms(tables, 3)
    t_solve = cuda_ms(lambda: solve(feats3, tabs), 5)
    t_solve5 = cuda_ms(lambda: solve(feats3, rtabs), 5)
    t_solve6 = cuda_ms(lambda: solve_rounds(feats3, rtabs), 3)
    with plain_rounds():
        t_solve6_plain = cuda_ms(lambda: solve_rounds(feats3, rtabs), 1)
    t_e2e = cuda_ms(lambda: solve(frontend(raw), tables()), 3)
    with plain_picking():
        t_e2e_plain = cuda_ms(lambda: solve(frontend(raw), tables()), 2)
    print(f"time: frontend {t_front / B:.4f} ms/scan, tables {t_tables:.2f} "
          f"ms, solve {t_solve / B:.4f} ms/scan ({B * 1e3 / t_solve:.1f} "
          f"scans/s), e2e {B * 1e3 / t_e2e:.1f} scans/s (tables included); "
          f"phase 5 solve (resident tables) {t_solve5 / B:.4f} ms/scan, "
          f"phase 6 solve (batch_register_pallas) {t_solve6 / B:.4f} ms/scan"
          f" ({t_solve6_plain / B:.4f} with the rounds on the parent's loop);"
          f" frontend with the picking on its plain version (the parent's "
          f"route) {t_front_plain / B:.4f} ms/scan, e2e "
          f"{B * 1e3 / t_e2e_plain:.1f} scans/s", flush=True)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    other_k = {k: (stat, matP, fc, fs,
                   *(block_fetch(tq[0], *tq[1], K=k)[1]
                     for tq in (queries["corner"], queries["surf"])))
               for k in kernels.SUPPORTED_K if k != K}
    gn_probes("shipped",
              lambda a, n, K=K, **kw: gn_round(*a, K=K, iters=n, **kw),
              gn_rounds, n_sm, other_k)
    for vname, call in variants.items():
        gn_probes(vname, call, gn_rounds, n_sm, other_k)
    fetch_probes(queries["surf"], rtabs[1],
                 presort_by_row(guesses_t, feats.surf_xyz, feats.surf_mask,
                                stab, origin, 2.0, dims),
                 lambda xyz, m: fetch_queries(stat[:, :6], xyz, m, stab,
                                              origin, 2.0, dims))

    loc_launches, loc_fetch, loc_err, loc_steps = localization_phase(dev)

    # ---- the ring-pick kernel against its plain version, bitwise, at
    # ring_pick_shapes' (a)-(d), with the diagnostic build's split ----
    loc_scan, _, _, loc_dsk, _ = loc_steps[0]
    shapes = ring_pick_shapes(dev, params, raw, loc_scan, loc_dsk)
    rp = ring_pick_probes(shapes, ring_pick_profile_build())
    main_shape = rp["(b) bench B=256 fast"]
    kt["ring_pick"] = (main_shape["ms"], main_shape["plain_ms"])
    bounds["ring_pick"] = (main_shape["bound_ms"], main_shape["bound_by"])
    lf_launches, lf_err = lower_face_phase(dev)
    dense_launches, dense_err, dense_fetch = dense_map_phase(dev, loc_steps)
    rp_rounds = rounds_probes(dev)
    main_rounds = rp_rounds["(a) phase 7 step 0 round 0"]
    kt["rounds_gn"] = (main_rounds["ms"], main_rounds["plain_ms"])
    bounds["rounds_gn"] = (main_rounds["bound_ms"], main_rounds["bound_by"])
    slam_launches, slam_err = slam_phase(dev)
    lio_launches, lio_err = lio_phase(dev)
    kitti_launches, kitti_err = kitti_phase(dev)
    ms_launches, ms_err = multisession_phase(dev)
    rp_lm = pose_graph_probes(dev)
    main_lm = rp_lm["(a) phase 8 window"]
    kt["pose_graph_lm"] = (main_lm["ms"], main_lm["plain_ms"])
    bounds["pose_graph_lm"] = (main_lm["bound_ms"], main_lm["bound_by"])
    rp_imu = imu_probes(dev)
    for name, rec in (("imu_chain_lm", rp_imu["chain"][
            "(a) phase 9 last full window"]),
                      ("preintegration", rp_imu["preint"][
                          "phase 9 interval"])):
        kt[name] = (rec["ms"], rec["plain_ms"])
        bounds[name] = (rec["bound_ms"], rec["bound_by"])
    rp_knn, rp_icp = knn_icp_probes(dev)
    scenes_ab = scene_turns(dev) if KI_AB else None
    rp_exact = exact_probes(dev, types.SimpleNamespace(
        feats=feats3, fmap=fmap, guesses=guesses_t,
        oracle_poses=oracle_poses))
    for name, rec in (("knn_stream", rp_knn["(b) FPFH phase 10 (c)"]),
                      ("icp", rp_icp["(a) phase 8 loop candidates"]),
                      ("exact_gn", rp_exact["(a) phase 8 solve 0"])):
        kt[name] = (rec["ms"], rec["plain_ms"])
        bounds[name] = (rec["bound_ms"], rec["bound_by"])
    sh_launches, sh_err = sharded_phase(dev, types.SimpleNamespace(
        feats=feats3, guesses=guesses_t, fmap=fmap, center=center, half=half,
        tabs=tabs, rtabs=rtabs, queries_surf=queries["surf"][1],
        ate_oracle_of=ate_oracle_of, oracle_poses=oracle_poses,
        pose6=pose6, gpu=smi,
        zero_counts=zero_counts, read_counts=read_counts))
    loc = {}
    for kind, (name, ms, plain_ms, b_ms, b_by) in loc_fetch.items():
        loc.setdefault(name, {})[kind] = {
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by}

    def localization(name):
        return {"launches_localization": loc_launches[name],
                "max_abs_err_localization": loc_err.get(name),
                "localization": loc.get(name),
                "launches_lower_face": lf_launches[name],
                "max_abs_err_lower_face": lf_err.get(name),
                "launches_raw_step": dense_launches[name],
                "max_abs_err_raw_step": dense_err.get(name),
                "launches_slam": slam_launches[name],
                "max_abs_err_slam": slam_err.get(name),
                "launches_lio": lio_launches[name],
                "max_abs_err_lio": lio_err.get(name),
                "launches_kitti": kitti_launches[name],
                "max_abs_err_kitti": kitti_err.get(name),
                "launches_multisession": ms_launches[name],
                "max_abs_err_multisession": ms_err.get(name),
                "launches_sharded": sh_launches[name],
                "max_abs_err_sharded": sh_err.get(name)}

    def entry(name, source, replaces, launches_, err, timed, **extra):
        return {"name": name, "route": "cuda",
                "source": "feature_base_pointcloud_registration_tpu_torch/"
                          f"csrc/{source}",
                "replaces": replaces, "launches": launches_,
                "max_abs_err": err, "ms": kt[timed][0],
                "plain_ms": kt[timed][1], "bound_ms": bounds[timed][0],
                "bound_by": bounds[timed][1], "library_ms": None, **extra}

    print(json.dumps({"kernels": [
        entry("block_fetch", "block_fetch.cu",
              tpu_kernel_line("pallas_fetch.py", "_fetch_kernel"),
              launches["block_fetch"], fetch_err, "fetch_surf",
              raw_step=dense_fetch, **localization("block_fetch")),
        entry("gn_round", "gn_round.cu",
              tpu_kernel_line("pallas_gn.py", "_gn_round_kernel"),
              launches["gn_round"], gn_err, "gn_round",
              ms_round0=kt["gn_round0"][0],
              bound_ms_round0=bounds["gn_round0"][0],
              launches_per_round=per_round, **localization("gn_round")),
        entry("resident_fetch", "resident_fetch.cu",
              tpu_kernel_line("pallas_fetch.py", "_resident_kernel"),
              launches5["resident_fetch"], res_err, "resident_surf",
              **localization("resident_fetch")),
        entry("ring_pick", "ring_pick.cu",
              tpu_kernel_line("features.py", "_ring_pick"),
              launches["ring_pick"],
              max(r["max_abs_err"] for r in rp.values()), "ring_pick",
              launches_phase5=launches5["ring_pick"],
              launches_phase6=launches6["ring_pick"],
              redesigned="the six sectors' candidate lists sorted at once, "
                         "a warp each; each list walked on a warp, 32 "
                         "candidates a step",
              probes={n: {k: r[k] for k in ("windows", "W", "strict", "ms",
                                            "graph_ms", "plain_ms",
                                            "bound_ms", "bound_by")}
                      | ({"split": r["split"]} if "split" in r else {})
                      for n, r in rp.items()},
              **localization("ring_pick")),
        entry("rounds_gn", "rounds_gn.cu",
              xla_loop_line("register.py", "lax.while_loop(iter_cond"),
              loc_launches["rounds_gn"],
              max(r["max_abs_err"] for r in rp_rounds.values()), "rounds_gn",
              max_abs_err_degenerate=max(r["degenerate_err"]
                                         for r in rp_rounds.values()),
              launches_phase6=launches6["rounds_gn"],
              probes={n: {k: r[k] for k in (
                  "B", "K", "Pc", "Ps", "cluster", "lane_iterations",
                  "equal_lanes", "flips", "ms", "plain_ms", "bound_ms",
                  "bound_by", "max_abs_err", "plain_card_vs_cpu_err",
                  "bitwise")} | {k: r[k] for k in ("split", "in_turns")
                                 if k in r}
                      for n, r in rp_rounds.items()},
              cluster=main_rounds["cluster"],
              cluster_probes={n: {k: r[k] for k in (
                  "cluster", "ms", "max_abs_err", "equal_lanes", "bitwise")}
                  | ({"iteration_us": r["split"]["iteration_us"]}
                     if "split" in r else {})
                  for n, r in ROUNDS_SWEEP["probes"].items()},
              cluster_sweep_us=ROUNDS_SWEEP["sizes"],
              steps_in_turns=ROUNDS_TURNS,
              **localization("rounds_gn")),
        entry("pose_graph_lm", "pose_graph_lm.cu",
              xla_loop_line("pose_graph.py", "lax.scan(", sub="graph"),
              slam_launches["pose_graph_lm"] + slam_launches[
                  "pose_graph_lm_b"],
              max(r["max_abs_err"] for r in rp_lm.values()
                  if isinstance(r, dict)),
              "pose_graph_lm",
              launches_by_route={
                  phase: {"A": lc["pose_graph_lm"],
                          "B": lc["pose_graph_lm_b"],
                          "blocks": lc["pose_graph_blocks"]}
                  for phase, lc in (("8", slam_launches), ("9", lio_launches),
                                    ("10b", kitti_launches),
                                    ("10d", ms_launches))},
              max_abs_err_blocks=rp_lm["blocks_max_abs_err"],
              redesigned="route A on H's envelope: the factors' columns in "
                         "one pass, each entry summed by one owner thread; "
                         "the envelope Cholesky (forward solve inside) on "
                         "warp 0 for narrow columns, the CTA for wide ones",
              probes={n: {k: r[k] for k in (
                  "K", "live", "iterations", "route", "launches", "ms",
                  "solve_ms", "plain_ms", "bound_ms", "bound_by",
                  "max_abs_err", "cost_rel_err", "accepts_equal",
                  "bitwise", "paths")} | {k: r[k] for k in (
                      "split", "in_turns", "other_split") if k in r}
                      for n, r in rp_lm.items() if isinstance(r, dict)},
              steps_in_turns={k: v for k, v in LM_AB.get("steps", {}).items()
                              if k.endswith("pose_graph_lm")}),
        entry("imu_chain_lm", "imu_chain_lm.cu",
              xla_loop_line("imu_graph.py", "lax.scan(", sub="graph"),
              lio_launches["imu_chain_lm"],
              max(r["max_abs_err"] for r in rp_imu["chain"].values()),
              "imu_chain_lm",
              launches_blocks=lio_launches["imu_chain_blocks"],
              max_rel_err_blocks=rp_imu["blocks_max_rel_err"],
              phase9_in_turns=IMU_INPUTS["in_turns"],
              redesigned="a block step on the CTA: warp 0 factors the "
                         "panel [A_kk; A_k+1,k] a lane a row (the forward "
                         "solve inside), 120 threads the Schur update, the "
                         "other warps stage the next blocks in shared "
                         "memory; the backward solve on warp 0",
              probes={n: {k: r[k] for k in (
                  "K", "live", "iterations", "ms", "plain_ms", "bound_ms",
                  "bound_by", "max_abs_err", "cost_rel_err",
                  "accepts_equal", "bitwise")} | {k: r[k] for k in (
                      "split", "in_turns", "other_split") if k in r}
                      for n, r in rp_imu["chain"].items()},
              steps_in_turns={k: v for k, v in LM_AB.get("steps", {}).items()
                              if k.endswith("imu_chain_lm")}),
        entry("preintegration", "preintegration.cu",
              xla_loop_line("preintegration.py", "lax.scan(body, init",
                            sub="imu"),
              lio_launches["preintegrate"],
              max(r["max_abs_err"] for r in rp_imu["preint"].values()),
              "preintegration",
              launches_propagate_states=lio_launches["propagate_states"],
              max_abs_err_propagate_states=max(
                  r["max_abs_err"] for r in rp_imu["propagate"].values()),
              propagate_states={k: rp_imu["propagate"]["phase 9 stream"][k]
                                for k in ("ms", "plain_ms", "bound_ms",
                                          "bound_by")},
              redesigned="each step split by what it depends on, a "
                         "pipeline of warps over 32-slot chunks (the live "
                         "slots compacted by a ballot; the dR and dR_dbg "
                         "chains; the per-sample terms; cov on one warp on "
                         "A's structure, the dense step where a skipped "
                         "zero meets a term that is not finite; the sums); "
                         "the propagation on one warp, no CTA barrier a "
                         "slot",
              phase9=rp_imu["phase9"],
              scenes_in_turns=rp_imu["scenes"],
              in_turns={f"{kind} {n}": r.get("in_turns")
                        for kind in ("preint", "propagate")
                        for n, r in rp_imu[kind].items()},
              probes={f"{kind} {n}": {k: r[k] for k in (
                  "N", "live", "ms", "graph_ms", "entry_ms", "plain_ms",
                  "bound_ms", "bound_by", "max_abs_err", "bitwise")}
                      | ({"split": r["split"]} if "split" in r else {})
                      for kind in ("preint", "propagate")
                      for n, r in rp_imu[kind].items()}),
        entry("knn_stream", "knn_stream.cu",
              xla_loop_line("knn.py", "lax.scan(body"),
              kitti_launches["knn_pairs"],
              max(r["max_abs_err"] for r in rp_knn.values()), "knn_stream",
              launches_by_phase={
                  "8 steps": slam_launches["knn"],
                  "8 exact check": slam_launches["knn_exact_check"],
                  "8 exact check, the plain loop a pass":
                      EXACT_TURNS["plain_knn_launches"],
                  "10b": kitti_launches["knn"],
                  "10c": kitti_launches["knn_pairs"],
                  "10d merge": ms_launches["knn"]},
              redesigned="the map split over a cluster of up to 16 CTAs a "
                         "query tile, merged through distributed shared "
                         "memory; masked slots compacted away as tiles are "
                         "staged; 2 queries a thread",
              split=None,
              in_turns={n: r.get("in_turns") for n, r in rp_knn.items()}
              | {"GPU test scenes": scenes_ab},
              probes={n: {k: r[k] for k in (
                  "S", "Q", "M", "k", "live", "ms", "call_ms", "plain_ms",
                  "bound_ms", "bound_by", "max_abs_err", "index_swaps",
                  "bitwise", "fma_max_abs_err", "fma_index_swaps")}
                      for n, r in rp_knn.items()}),
        entry("icp", "icp.cu", xla_loop_line("icp.py", "lax.while_loop("),
              slam_launches["icp"],
              max(r["max_abs_err"] for r in rp_icp.values()), "icp",
              launches_by_phase={"8": slam_launches["icp"],
                                 "10b": kitti_launches["icp"],
                                 "10c": kitti_launches["icp_pairs"],
                                 "10d merge": ms_launches["icp"]},
              phase8_in_turns=ICP_TURNS,
              redesigned="an exact 1-NN over a cell index built once a run "
                         "(shells of cells, a proven rounding margin, the "
                         "last trip's neighbour as the seed), a row a group "
                         "of lanes in its own CTA, 4 grid barriers a trip",
              split={n: {k: r[k] for k in ("split", "other_split")
                         if k in r} for n, r in rp_icp.items()},
              in_turns={n: r.get("in_turns") for n, r in rp_icp.items()}
              | {"phase 8": ICP_TURNS.get("other_ms") and {
                  k: ICP_TURNS[k] for k in ("kernel_ms", "other_ms",
                                            "bitwise_other")},
                 "GPU test scenes": scenes_ab},
              probes={n: {k: r[k] for k in (
                  "N", "M", "live", "iterations", "plain_iterations", "ms",
                  "no_iteration_ms", "trip_ms", "plain_ms", "bound_ms",
                  "bound_by", "bound_visited_ms", "max_abs_err",
                  "plain_card_vs_cpu_err", "fitness", "plain_fitness",
                  "bitwise", "fma_max_abs_err")}
                      for n, r in rp_icp.items()}),
        entry("exact_gn", "exact_gn.cu",
              xla_loop_line("register.py",
                            "it, state = lax.while_loop(cond, body"),
              slam_launches["exact_gn"],
              max(r["max_abs_err"] for r in rp_exact.values()), "exact_gn",
              max_abs_err_degenerate=max(r["degenerate_err"]
                                         for r in rp_exact.values()),
              launches_by_phase={
                  "8": slam_launches["exact_gn"],
                  "probe (b) batch_register": rp_exact[
                      f"(b) batch_register B={N_EXACT_BATCH}"]["launches"]},
              phase8_in_turns=EXACT_TURNS,
              probes={n: {k: r[k] for k in (
                  "B", "Pc", "Ps", "Mc", "Ms", "live_features", "live_map",
                  "cluster", "lane_iterations", "flips", "equal_lanes", "ms",
                  "plain_ms", "bound_ms", "bound_by", "max_abs_err",
                  "degenerate_err", "held_to", "plain_card_vs_cpu_err",
                  "plain_card_vs_cpu_lanes", "index_swaps", "nn_slots",
                  "bitwise")}
                  | {k: r[k] for k in ("ate_vs_oracle_m",
                                       "plain_ate_vs_oracle_m") if k in r}
                      for n, r in rp_exact.items()}),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
