// The per-level geometry every encoder kernel takes by value, shared by the
// sources in csrc/ and mirrored by ops/cuda_lib.py HbrLevels.
#pragma once

#define HBR_MAX_LEVELS 16

struct HbrLevels {
  int n_levels;
  int size[HBR_MAX_LEVELS];    // G_l: line length (CP), grid side (dense) or
                               // table size T (hash)
  int offset[HBR_MAX_LEVELS];  // CP: first row of level l in the packed lines;
                               // dense: first element of grid l;
                               // hash: first row l*T of level l in the table
  float scale[HBR_MAX_LEVELS];  // level resolution N_l, as f32
};
